"""The test-time data transforms, on tensors: ``RResize``, ``Normalize``
and ``Pad``.

Port of the test side of ``r3det_tpu/datasets/transforms.py``. Samples are
dicts as there (``img``, ``img_shape``, ``scale_factor``, ``gt_bboxes``,
``pad_shape``), but ``img`` is a tensor (H, W, C) on a device of the
caller's choosing: the eval loop copies the decoded uint8 image to the card
and transforms it there.

- ``RResize`` computes OpenCV's ``cv2.resize(..., INTER_LINEAR)`` on uint8
  in integers, to the bit: source coordinate ``(d + 0.5) * src / dst -
  0.5`` in float32, 11-bit fixed-point weights rounded each on its own,
  the horizontal sums in int32, the vertical ``((b0 * (r0 >> 4)) >> 16) +
  ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``, x clamped to the image, y rows
  clipped (their weights are not). An exact 2x downscale in both axes is,
  as in OpenCV, the rounded mean of each 2x2 block.
- ``Normalize`` (f32, BGR -> RGB, ``(x - mean) / std``) and ``Pad`` (to a
  fixed canvas or a size divisor) are IEEE operations: a card gives the
  CPU's result.

``RRandomFlip``, ``PolyRandomRotate``, ``TrainPipeline`` and ``pad_gt``
belong to the training data path and are not ported yet.
"""
import numpy as np
import torch

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
