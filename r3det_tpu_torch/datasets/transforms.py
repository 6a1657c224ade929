"""The data transforms, on tensors: the train side (``RRandomFlip``,
``PolyRandomRotate``, ``pad_gt``, ``TrainPipeline``) and the stages both
sides share (``RResize``, ``Normalize``, ``Pad``).

Port of ``r3det_tpu/datasets/transforms.py``. Samples are dicts as there
(``img``, ``img_shape``, ``scale_factor``, ``gt_bboxes``, ``gt_labels``,
``pad_shape``), but ``img`` is a tensor (H, W, C) on a device of the
caller's choosing: the eval loop and ``TrainPipeline`` copy the decoded
uint8 image to the card and transform it there. Boxes stay numpy on the
host and follow the JAX package's numpy rules; the random draws come from
one ``np.random.RandomState`` in the JAX package's order.

- ``RResize`` computes OpenCV's ``cv2.resize(..., INTER_LINEAR)`` on uint8
  in integers, to the bit: source coordinate ``(d + 0.5) * src / dst -
  0.5`` in float32, 11-bit fixed-point weights rounded each on its own,
  the horizontal sums in int32, the vertical ``((b0 * (r0 >> 4)) >> 16) +
  ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``, x clamped to the image, y rows
  clipped (their weights are not). An exact 2x downscale in both axes is,
  as in OpenCV, the rounded mean of each 2x2 block.
- ``warp_affine_linear`` computes ``cv2.warpAffine(..., INTER_LINEAR)``
  with its constant 0 border on uint8, to the bit, in IEEE float32 with
  OpenCV 5.0's fused multiply-adds (see its docstring);
  ``get_rotation_matrix_2d`` and ``transform_points`` are
  ``cv2.getRotationMatrix2D`` and ``cv2.transform`` in float64.
- ``Normalize`` (f32, BGR -> RGB, ``(x - mean) / std``), ``Pad`` (to a
  fixed canvas or a size divisor) and the flips are IEEE operations or
  copies: a card gives the CPU's result.
"""
import math

import numpy as np
import torch

from .. import _host
from ..core.rtransforms_np import norm_angle_np, obb2poly_np, polys2obbs_np

PI = math.pi

INTER_RESIZE_COEF_SCALE = 2048            # 11-bit weights


def _linear_axis(src, dst, clamp):
    """cv2's INTER_LINEAR tables along one axis: the two source indices
    and their int32 weights for each of ``dst`` outputs. ``clamp`` (the x
    axis) pins outputs beyond the edge to the edge sample with weight 1;
    on the y axis only the row indices are clipped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(INTER_RESIZE_COEF_SCALE))
    w1 = np.rint(f * np.float32(INTER_RESIZE_COEF_SCALE))
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, w0.astype(np.int32), w1.astype(np.int32)


def resize_linear(img, new_w, new_h):
    """``cv2.resize(img, (new_w, new_h), interpolation=INTER_LINEAR)`` of a
    uint8 (H, W, C) tensor, on its device."""
    if img.dtype != torch.uint8:
        raise ValueError(f'resize_linear takes uint8, got {img.dtype}')
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return img.clone()
    x = img.to(torch.int32)
    if w == 2 * new_w and h == 2 * new_h:          # cv2: INTER_AREA, fast
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] +
               x[1::2, 1::2] + 2) >> 2
        return out.to(torch.uint8)
    dev = img.device

    def table(src, dst, clamp):
        return [torch.from_numpy(t).to(dev)
                for t in _linear_axis(src, dst, clamp)]

    xi0, xi1, a0, a1 = table(w, new_w, True)
    yi0, yi1, b0, b1 = table(h, new_h, False)
    a0, a1 = a0[:, None], a1[:, None]
    rows = x[:, xi0] * a0 + x[:, xi1] * a1           # (H, new_w, C)
    r0, r1 = rows[yi0] >> 4, rows[yi1] >> 4
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


# OpenCV 5.0's warpAffine runs the columns of a row in steps of two AVX2
# float32 vectors; the last (width % 16) columns take its scalar loop,
# whose source coordinate rounds in another order.
WARP_SIMD_COLS = 16


def get_rotation_matrix_2d(center, angle, scale=1.0):
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64,
    ``angle`` in degrees, counter-clockwise. OpenCV takes the centre as
    float32 (``cv::Point2f``) and the rest in double with libm's cos and
    sin."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def transform_points(points, M):
    """``cv2.transform`` of (N, 2) points by the (2, 3) affine ``M``, in
    float64 as OpenCV 5.0's build computes it (the C++ host helper,
    ``std::fma``): ``fma(m0, x, m1 * y) + m2`` per coordinate, or
    ``fma(m0, x, m2)`` where both off-diagonal entries are within
    DBL_EPSILON of 0 (OpenCV's diagonal path: a rotation by 180 degrees).
    """
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    m = np.ascontiguousarray(M, dtype=np.float64).reshape(6)
    out = np.empty_like(pts)
    if len(pts):
        _host.host_ops().transform_points(pts.ctypes.data, m.ctypes.data,
                                          out.ctypes.data, len(pts))
    return out


def _invert_affine(M):
    """cv::warpAffine's inverse of ``M`` in double, its order of
    operations: the six coefficients as Python floats."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m


def _fma32(a, b, c):
    """``a * b + c`` of float32 tensors with one rounding to float32 (a
    fused multiply-add), on any device: in float64, where ``a * b`` is
    exact, with the ties that rounding twice could break the wrong way
    settled by the sum's exact remainder (TwoSum)."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)             # s + err == p + c exactly
    r = s.float()
    r64 = r.double()
    up = s > r64
    n = torch.nextafter(r, torch.where(up, math.inf, -math.inf).float())
    tie = (s != r64) & (s == (r64 + n.double()) * 0.5) & (err != 0) & \
        ((err > 0) == up)
    return torch.where(tie, n, r)


def warp_affine_linear(img, M, dsize):
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR)`` of a uint8
    (H, W, C) tensor, with the default constant border 0, on its device;
    ``dsize`` is (width, height).

    OpenCV 5.0 (the rule was found by comparison with cv2 5.0, bit-equal on
    random images, matrices and sizes; its older fixed-point rule with a
    32 x 32 weight table is not what it computes): ``M`` inverted in
    double and cast to float32; for output (x, y) the source coordinate
    ``fma(m0, x, y * m1 + m2)`` (the row term rounded twice) in the
    vector columns and ``fma(x, m0, y * m1) + m2`` in the last ``width %
    16``; ``ix = floor(sx)``, ``alpha = sx - ix`` in float32; the four
    taps (0 outside the image) blended as ``v0 = fma(alpha, p01 - p00,
    p00)``, ``v1 = fma(alpha, p11 - p10, p10)``, ``v = fma(beta, v1 - v0,
    v0)``; rounded half to even and saturated to uint8."""
    if img.dtype != torch.uint8:
        raise ValueError(f'warp_affine_linear takes uint8, got {img.dtype}')
    bw, bh = (int(v) for v in dsize)
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    h, w, ch = x.shape
    dev = img.device
    m = torch.tensor(np.float32(_invert_affine(M)), device=dev)
    xs = torch.arange(bw, dtype=torch.float32, device=dev)
    ys = torch.arange(bh, dtype=torch.float32, device=dev)[:, None]
    nvec = bw - bw % WARP_SIMD_COLS

    def coord(m0, m1, m2):
        vec = _fma32(m0, xs[:nvec], ys * m1 + m2)
        tail = _fma32(xs[nvec:], m0, ys * m1) + m2
        return torch.cat([vec.expand(bh, nvec), tail.expand(bh, bw - nvec)],
                         1)

    sx, sy = coord(m[0], m[1], m[2]), coord(m[3], m[4], m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    alpha, beta = (sx - fx)[..., None], (sy - fy)[..., None]
    # the image in a frame of zeros: taps outside it read the frame
    pad = x.new_zeros((h + 2, w + 2, ch))
    pad[1:-1, 1:-1] = x
    pad = pad.reshape(-1, ch).float()
    ix, iy = fx.long(), fy.long()

    def taps(dy):
        row = (iy + dy).clamp(-1, h) + 1
        i0 = row * (w + 2) + ix.clamp(-1, w) + 1
        i1 = row * (w + 2) + (ix + 1).clamp(-1, w) + 1
        return pad[i0], pad[i1]

    p00, p01 = taps(0)
    p10, p11 = taps(1)
    v0 = _fma32(alpha, p01 - p00, p00)
    v1 = _fma32(alpha, p11 - p10, p10)
    out = torch.round(_fma32(beta, v1 - v0, v0)).clamp_(0, 255)
    out = out.to(torch.uint8)
    return out[..., 0] if squeeze else out


class RResize:
    """Resize image (keep-ratio) + rotated boxes.

    Box rule (the reference's pipelines/rtransforms.py:30-40): centers
    scale per axis, w/h by sqrt(wx * wy)."""

    def __init__(self, img_scale):
        self.img_scale = img_scale          # (w, h) target, mmcv convention

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        max_long, max_short = max(self.img_scale), min(self.img_scale)
        scale = min(max_long / max(h, w), max_short / min(h, w))
        new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        img = resize_linear(img, new_w, new_h)
        w_scale, h_scale = new_w / w, new_h / h
        results['img'] = img
        results['img_shape'] = tuple(img.shape)
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results and len(results['gt_bboxes']):
            b = results['gt_bboxes']
            b[:, 0] *= w_scale
            b[:, 1] *= h_scale
            b[:, 2:4] *= np.sqrt(w_scale * h_scale)
        return results


class RRandomFlip:
    """Random h/v/diagonal flip of image + (cx, cy, w, h, theta) boxes.

    Angle rules (the reference's pipelines/rtransforms.py:59-89): v1
    reflects via theta -> -pi/2 - theta with w/h swap (except theta ==
    -pi/2); v2/v3 via norm_angle(pi - theta). The image is flipped on its
    device; the boxes stay numpy."""

    _DIMS = {'horizontal': (1,), 'vertical': (0,), 'diagonal': (0, 1)}

    def __init__(self, flip_ratio=0.5, direction='horizontal', version='v1',
                 rng=None):
        self.flip_ratio = flip_ratio
        self.direction = direction
        self.version = version
        self.rng = rng or np.random

    def bbox_flip(self, bboxes, img_shape, direction):
        h, w = img_shape[:2]
        flipped = bboxes.copy()
        if direction == 'horizontal':
            flipped[:, 0] = w - bboxes[:, 0] - 1
        elif direction == 'vertical':
            flipped[:, 1] = h - bboxes[:, 1] - 1
        elif direction == 'diagonal':
            flipped[:, 0] = w - bboxes[:, 0] - 1
            flipped[:, 1] = h - bboxes[:, 1] - 1
            return flipped                     # 180 deg rotation: angle kept
        else:
            raise ValueError(f'bad flip direction {direction!r}')
        if self.version == 'v1':
            rot = bboxes[:, 4] != -PI / 2
            flipped[rot, 4] = -PI / 2 - bboxes[rot, 4]
            flipped[rot, 2] = bboxes[rot, 3]
            flipped[rot, 3] = bboxes[rot, 2]
        else:
            flipped[:, 4] = norm_angle_np(PI - bboxes[:, 4], self.version)
        return flipped

    def __call__(self, results):
        if self.rng.rand() >= self.flip_ratio:
            results['flip'] = False
            return results
        if self.direction not in self._DIMS:
            raise ValueError(f'bad flip direction {self.direction!r}')
        results['flip'] = True
        results['flip_direction'] = self.direction
        results['img'] = results['img'].flip(self._DIMS[self.direction])
        if 'gt_bboxes' in results and len(results['gt_bboxes']):
            results['gt_bboxes'] = self.bbox_flip(
                results['gt_bboxes'], tuple(results['img'].shape),
                self.direction)
        return results


class PolyRandomRotate:
    """Random in-plane rotation through polygon space.

    The reference's pipelines/rtransforms.py:92-226: a random angle in
    +-angles_range degrees, snapped to {90, 180, -90, -180} when
    storage-tank (9) or roundabout (11) instances are present; the image
    warped on its device (``warp_affine_linear``), the boxes taken obb ->
    poly -> ``transform_points`` -> re-fit obb in numpy; a border and
    min-size filter; ``None`` when no gt survives (the loader resamples).
    """

    def __init__(self, rotate_ratio=0.5, angles_range=180, auto_bound=False,
                 version='v3', rng=None):
        self.rotate_ratio = rotate_ratio
        self.angles_range = angles_range
        self.auto_bound = auto_bound
        self.version = version
        self.discrete_range = [90, 180, -90, -180]
        self.rng = rng or np.random

    def __call__(self, results):
        # the reference runs the angle-0 path when NOT rotating too
        # (pipelines/rtransforms.py:168-172 + :206-224): the boxes still
        # go obb -> poly -> (identity) transform -> re-fit -> filter, and
        # a sample whose gt all die returns None
        if self.rng.rand() >= self.rotate_ratio:
            results['rotate'] = False
            angle = 0.0
        else:
            angle = 2 * self.angles_range * self.rng.rand() - \
                self.angles_range
            results['rotate'] = True
            labels = results['gt_labels']
            if np.any((labels == 9) | (labels == 11)):
                angle = self.discrete_range[self.rng.randint(4)]
        labels = results['gt_labels']
        results['rotate_angle'] = angle

        img = results['img']
        h, w = img.shape[:2]
        center = (w / 2, h / 2)
        if self.auto_bound:
            # quirk kept: the reference feeds the DEGREE angle to np.cos /
            # np.sin for the bounds (pipelines/rtransforms.py:191-196)
            ac, as_ = abs(np.cos(angle)), abs(np.sin(angle))
            bound_w = int(np.rint(h * as_ + w * ac))
            bound_h = int(np.rint(h * ac + w * as_))
        else:
            bound_w, bound_h = w, h
        rm = get_rotation_matrix_2d(center, angle, 1)
        rm_img = get_rotation_matrix_2d((center[0] - 0.5, center[1] - 0.5),
                                        angle, 1)
        if results['rotate']:
            results['img'] = warp_affine_linear(img, rm_img,
                                                (bound_w, bound_h))
            results['img_shape'] = tuple(results['img'].shape)

        gt = results['gt_bboxes']
        if len(gt) == 0:
            return None
        scored = np.concatenate([gt, np.zeros((len(gt), 1))], -1)
        polys = obb2poly_np(scored, self.version)[:, :8].reshape(-1, 2)
        polys = transform_points(polys.astype(float), rm).reshape(-1, 8)
        new_boxes = [obb if obb is not None else (0, 0, 0, 0, 0)
                     for obb in polys2obbs_np(polys.astype(np.float32),
                                              self.version)]
        new_boxes = np.array(new_boxes, np.float32).reshape(-1, 5)
        keep = ((new_boxes[:, 0] > 0) & (new_boxes[:, 0] < bound_w) &
                (new_boxes[:, 1] > 0) & (new_boxes[:, 1] < bound_h) &
                (new_boxes[:, 2] > 5) & (new_boxes[:, 3] > 5))
        if not keep.any():
            return None
        results['gt_bboxes'] = new_boxes[keep]
        results['gt_labels'] = labels[keep]
        return results


class Normalize:
    """Channel normalize + BGR->RGB (mmdet Normalize with to_rgb), f32."""

    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].to(torch.float32)
        if self.to_rgb:
            img = img.flip(-1)
        mean = torch.from_numpy(self.mean).to(img.device)
        std = torch.from_numpy(self.std).to(img.device)
        results['img'] = (img - mean) / std
        return results


class Pad:
    """Pad image to a size divisor (bottom/right), mmdet Pad semantics;
    ``fixed_size`` ((h, w)) pads to an exact canvas instead, so every
    sample of a batch has one shape."""

    def __init__(self, size_divisor=32, pad_val=0.0, fixed_size=None):
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.fixed_size = fixed_size

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.fixed_size is not None:
            ph, pw = self.fixed_size
            if h > ph or w > pw:
                raise ValueError(f'image {(h, w)} exceeds the fixed pad '
                                 f'canvas {(ph, pw)}')
        else:
            ph = (h + self.size_divisor - 1) // self.size_divisor * \
                self.size_divisor
            pw = (w + self.size_divisor - 1) // self.size_divisor * \
                self.size_divisor
        if (ph, pw) != (h, w):
            out = img.new_full((ph, pw) + tuple(img.shape[2:]), self.pad_val)
            out[:h, :w] = img
            results['img'] = out
        results['pad_shape'] = tuple(results['img'].shape)
        return results


def pad_gt(gt_bboxes, gt_labels, max_gt):
    """Pad variable gt to fixed (max_gt, 5) / (max_gt,) numpy arrays + a
    mask; an overflow keeps the ``max_gt`` largest boxes by area (they
    dominate the loss)."""
    n = len(gt_bboxes)
    boxes = np.zeros((max_gt, 5), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    if n == 0:
        return boxes, labels, mask
    if n > max_gt:
        order = np.argsort(-(gt_bboxes[:, 2] * gt_bboxes[:, 3]))[:max_gt]
        gt_bboxes = gt_bboxes[order]
        gt_labels = gt_labels[order]
        n = max_gt
    boxes[:n] = gt_bboxes
    labels[:n] = gt_labels
    mask[:n] = True
    return boxes, labels, mask


class TrainPipeline:
    """Composed train pipeline -> one fixed-size sample of tensors on
    ``device`` (the card unless the caller asks for the CPU): ``image``
    (H, W, 3) f32, ``gt_bboxes`` (max_gt, 5) f32, ``gt_labels`` (max_gt,)
    int32, ``gt_mask`` (max_gt,) bool.

    Stage order as configs/_base_/datasets/dota1_0.py:6-15: RResize ->
    RRandomFlip [-> PolyRandomRotate] -> Normalize -> Pad. The random
    stages draw from one ``RandomState(seed)`` in that order. A stage
    returning None (PolyRandomRotate killing every gt) gives None; the
    loader resamples.
    """

    def __init__(self, img_scale=(1024, 1024), flip_ratio=0.5, version='v1',
                 with_rotate=False, rotate_kwargs=None, max_gt=256,
                 seed=None, device='cuda'):
        rng = np.random.RandomState(seed)
        stages = [RResize(img_scale),
                  RRandomFlip(flip_ratio, version=version, rng=rng)]
        if with_rotate:
            stages.append(PolyRandomRotate(
                version=version, rng=rng, **(rotate_kwargs or {})))
        stages += [Normalize(), Pad(32)]
        self._setup(stages, max_gt, device)

    def _setup(self, stages, max_gt, device):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("TrainPipeline: no CUDA card; pass "
                               "device='cpu' to transform on the CPU")
        self.stages = stages
        self.max_gt = max_gt
        self.device = device

    @classmethod
    def from_config(cls, pipeline_cfg, version='v1', max_gt=256, seed=None,
                    device='cuda'):
        """Build from a config's pipeline dict list: every stage's
        parameters (img_scale, flip_ratio, rotate_ratio, angles_range,
        mean/std, size_divisor) take effect as in the reference
        (configs/_base_/datasets/dota1_0.py:6-15). The load, format and
        collect stages are the dataset's and the loader's job, so they
        are accepted and skipped."""
        self = cls.__new__(cls)
        rng = np.random.RandomState(seed)
        skipped = {'LoadImageFromFile', 'LoadAnnotations',
                   'DefaultFormatBundle', 'Collect'}
        stages = []
        for s in pipeline_cfg:
            s = dict(s)
            t = s.pop('type')
            if t in skipped:
                continue
            elif t == 'RResize':
                stages.append(RResize(tuple(s['img_scale'])))
            elif t == 'RRandomFlip':
                stages.append(RRandomFlip(
                    flip_ratio=s.get('flip_ratio', 0.5),
                    direction=s.get('direction', 'horizontal'),
                    version=s.get('version', version), rng=rng))
            elif t == 'PolyRandomRotate':
                stages.append(PolyRandomRotate(
                    rotate_ratio=s.get('rotate_ratio', 0.5),
                    angles_range=s.get('angles_range', 180),
                    auto_bound=s.get('auto_bound', False),
                    version=s.get('version', version), rng=rng))
            elif t == 'Normalize':
                stages.append(Normalize(
                    mean=s.get('mean', (123.675, 116.28, 103.53)),
                    std=s.get('std', (58.395, 57.12, 57.375)),
                    to_rgb=s.get('to_rgb', True)))
            elif t == 'Pad':
                stages.append(Pad(s.get('size_divisor', 32),
                                  s.get('pad_val', 0.0)))
            else:
                raise ValueError(f'unknown pipeline stage type {t!r}')
        self._setup(stages, max_gt, device)
        return self

    def pad_to(self, h, w):
        """Pin the Pad stage to an exact (h, w) canvas, so every sample of
        a batch has one shape; appends a Pad stage if there is none."""
        for stage in self.stages:
            if isinstance(stage, Pad):
                stage.fixed_size = (h, w)
                return
        self.stages.append(Pad(32, fixed_size=(h, w)))

    def __call__(self, results):
        """A dataset sample (``get_sample``: uint8 ``img`` on the host)
        -> the fixed-size tensors, or None."""
        if isinstance(results['img'], np.ndarray):
            results['img'] = torch.from_numpy(results['img']).to(self.device)
        for stage in self.stages:
            results = stage(results)
            if results is None:
                return None
        boxes, labels, mask = pad_gt(results['gt_bboxes'],
                                     results['gt_labels'], self.max_gt)
        return {'image': results['img'].to(self.device, torch.float32),
                **{k: torch.from_numpy(v).to(self.device) for k, v in
                   (('gt_bboxes', boxes), ('gt_labels', labels),
                    ('gt_mask', mask))}}
