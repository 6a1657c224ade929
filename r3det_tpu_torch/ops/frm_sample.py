"""FRM bilinear sample: the plain PyTorch form and the CUDA kernel (K2).

Port of ``r3det_tpu/models/frm.py::bilinear_sample`` and
``feature_refine_sample`` (points 1 and 5), and of the TPU kernel
``r3det_tpu/ops/frm_sample.py::bilinear_sample_band``, whose CUDA
counterpart is ``csrc/frm_sample.cu``. One kernel replaces both TPU
routes: it reads each point's 4 corner rows directly, so it needs neither
the band kernel's stencil window nor its outlier correction, and it takes
all levels of an FRM stage in one launch.

The fused op of one pyramid level is ``x + (feat + acc)``: ``feat`` is
the FRM branch-conv output, ``acc`` its bilinear sample at each cell's
best-box centre (points=1), or that sample followed by the samples at the
box's four corners (points=5), each rounded to ``feat``'s dtype and added
to the running sum in that dtype. The reference's transposed-coordinate
quirk is on by default (row <- cx * scale, col <- cy * scale). Corner
weights stay f32 (JAX's gather rounded them to ``feat``'s dtype; the band
kernel kept f32).

On CUDA tensors :func:`frm_sample_levels` is a ``torch.autograd.Function``
over the flat ``(*xs, *feats)`` (``rois`` and the scales carry no
gradient): its backward gives ``dx = g`` itself and ``dfeat = g + S^T g``,
``S^T`` scattering each cell's gradient, times the f32 weights of the
corners its points read, onto those corners, by one launch of K2's
backward kernel for all levels (:func:`frm_sample_levels_bwd_cuda`,
accumulating in f32 with atomics). Its plain version is autograd through
:func:`frm_sample_levels_reference` (:func:`frm_sample_levels_bwd_reference`).
"""
import ctypes

import torch

from .. import _ext

MAX_LEVELS = 8            # levels of one kernel launch
# the corner sign pairs (sw, sh) on a box's (w, h) axis vectors: the
# reference's p1..p4 order (feature_refine_kernel.cu:146-150)
CORNER_SIGNS = ((1, 1), (-1, 1), (-1, -1), (1, -1))


def bilinear_sample(feat, py, px):
    """Bilinear sample of ``feat`` (B, H, W, C) at fractional (row, col)
    points ``py``, ``px`` (B, N) -> (B, N, C) in ``feat``'s dtype.

    Points outside (-1, H) x (-1, W) give 0; inside, coordinates clamp to
    the map (the reference's bilinear_interpolate boundary rule). Weights
    and sums are f32.
    """
    b, h, w, c = feat.shape
    py = py.float()
    px = px.float()
    inside = (py > -1.0) & (py < h) & (px > -1.0) & (px < w)
    py = py.clamp(0.0, h - 1.0)
    px = px.clamp(0.0, w - 1.0)
    y0 = py.floor().long()
    x0 = px.floor().long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    ly = py - y0
    lx = px - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(b, h * w, c)

    def corner(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, c)
        return flat.gather(1, idx).float()

    val = ((hy * hx)[..., None] * corner(y0, x0)
           + (hy * lx)[..., None] * corner(y0, x1)
           + (ly * hx)[..., None] * corner(y1, x0)
           + (ly * lx)[..., None] * corner(y1, x1))
    val = torch.where(inside[..., None], val, torch.zeros_like(val))
    return val.to(feat.dtype)


def sample_coords(rois, spatial_scale, transpose_quirk=True):
    """(row, col) sample points (B, H*W) of the rois' centres on a level."""
    cx = rois[..., 0] * spatial_scale
    cy = rois[..., 1] * spatial_scale
    return (cx, cy) if transpose_quirk else (cy, cx)


def feature_refine_sample(feat, best_bboxes, spatial_scale, points=1,
                          transpose_quirk=True):
    """FR op of one level, plain form: feat (B, H, W, C), best_bboxes
    (B, H*W, 5) -> feat + the sum of bilinear samples at the box points."""
    if points not in (1, 5):
        raise ValueError('points must be 1 or 5')
    b, h, w, c = feat.shape
    row0, col0 = sample_coords(best_bboxes, spatial_scale, transpose_quirk)
    acc = bilinear_sample(feat, row0, col0).reshape(b, h, w, c)
    if points == 5:
        cx = best_bboxes[..., 0] * spatial_scale
        cy = best_bboxes[..., 1] * spatial_scale
        bw = best_bboxes[..., 2] * spatial_scale
        bh = best_bboxes[..., 3] * spatial_scale
        a = best_bboxes[..., 4]
        cosa, sina = torch.cos(a), torch.sin(a)
        wx, wy = cosa * bw / 2, sina * bw / 2
        hx, hy = -sina * bh / 2, cosa * bh / 2
        for sw, sh in CORNER_SIGNS:
            dx = sw * wx + sh * hx
            dy = sw * wy + sh * hy
            if transpose_quirk:
                r, cc = cx + dy, cy + dx
            else:
                r, cc = cy + dy, cx + dx
            acc = acc + bilinear_sample(feat, r, cc).reshape(b, h, w, c)
    return feat + acc


def frm_sample_reference(x, feat, rois, spatial_scale, transpose_quirk=True,
                         points=1):
    """Plain version of :func:`frm_sample`: ``x + (feat + acc)``."""
    return x + feature_refine_sample(feat, rois, spatial_scale, points,
                                     transpose_quirk)


def frm_sample_levels_reference(xs, feats, rois, scales, points=1,
                                transpose_quirk=True):
    """Plain version of :func:`frm_sample_levels`: one
    :func:`frm_sample_reference` a level."""
    return [frm_sample_reference(x, f, r, s, transpose_quirk, points)
            for x, f, r, s in zip(xs, feats, rois, scales)]


def _check_level(x, feat, rois, device, b, c):
    """Raise ValueError unless one level is what the kernel takes."""
    for name, t in (('x', x), ('feat', feat)):
        if t.dim() != 4 or t.dtype != torch.bfloat16 \
                or t.shape != feat.shape or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f'{name} must be a contiguous NHWC bfloat16 '
                             f'tensor of feat\'s shape on {device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must start on a 16-byte boundary')
    if feat.shape[0] != b or feat.shape[3] != c:
        raise ValueError(f'every level must have batch {b} and {c} '
                         f'channels, got {tuple(feat.shape)}')
    if c % 8:
        raise ValueError(f'the channel count must be a multiple of 8, '
                         f'got {c}')
    h, w = feat.shape[1:3]
    if rois.dtype != torch.float32 or tuple(rois.shape) != (b, h * w, 5) \
            or not rois.is_contiguous() or rois.device != device:
        raise ValueError(f'rois must be a contiguous (B, H*W, 5) float32 '
                         f'tensor on feat\'s device, got {rois.dtype} '
                         f'{tuple(rois.shape)}')


def _check_cuda(device):
    if device.type != 'cuda':
        raise ValueError(f'the K2 kernel takes CUDA tensors, got {device}')


def frm_sample_cuda(x, feat, rois, spatial_scale, transpose_quirk=True):
    """Launch the K2 kernel (``csrc/frm_sample.cu``) on one level's CUDA
    tensors, points=1."""
    _check_level(x, feat, rois, feat.device, feat.shape[0], feat.shape[-1])
    _check_cuda(feat.device)
    b, h, w, c = feat.shape
    out = torch.empty_like(feat)
    _ext.launch('frm_sample', x.data_ptr(), feat.data_ptr(), rois.data_ptr(),
                out.data_ptr(), b, h, w, c, float(spatial_scale),
                int(bool(transpose_quirk)), _ext.current_stream(feat.device))
    return out


def frm_sample_levels_cuda(xs, feats, rois, scales, points=1,
                           transpose_quirk=True, trig=None):
    """Launch the K2 kernel once for every level of an FRM stage (CUDA
    tensors). For points=5 the cos and sin of every box angle are taken
    here (unless given as ``trig``), by PyTorch's own ops (as the plain
    form takes them), in one pass over all levels' angles."""
    n = len(feats)
    if not 1 <= n <= MAX_LEVELS or not len(xs) == len(rois) == len(scales) \
            == n:
        raise ValueError(f'1 to {MAX_LEVELS} levels, each with x, feat, '
                         f'rois and a scale; got {len(xs)}, {n}, '
                         f'{len(rois)} and {len(scales)}')
    if points not in (1, 5):
        raise ValueError('points must be 1 or 5')
    dev = feats[0].device
    b, c = feats[0].shape[0], feats[0].shape[-1]
    for x, f, r in zip(xs, feats, rois):
        _check_level(x, f, r, dev, b, c)
    _check_cuda(dev)
    outs = [torch.empty_like(f) for f in feats]
    if points == 5 and trig is None:
        trig = angle_trig(rois)
    _ext.launch('frm_sample_levels', *levels_args(
        xs, feats, rois, outs, scales, trig, points, transpose_quirk))
    return outs


def angle_trig(rois):
    """(2, cells) f32: the cos, then the sin, of every level's box angles,
    by PyTorch's ops (the plain form's), in one pass."""
    ang = torch.cat([r[..., 4].reshape(-1) for r in rois])
    trig = torch.empty((2, ang.numel()), dtype=torch.float32,
                       device=ang.device)
    torch.cos(ang, out=trig[0])
    torch.sin(ang, out=trig[1])
    return trig


def levels_args(xs, feats, rois, outs, scales, trig, points, transpose_quirk):
    """The arguments of the C entry point ``r3det_frm_sample_levels`` for
    checked levels: host arrays of the levels' pointers, sizes and
    scales."""
    n = len(feats)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    return (n, ptrs(xs), ptrs(feats), ptrs(rois), ptrs(outs),
            (ctypes.c_int * n)(*(f.shape[1] for f in feats)),
            (ctypes.c_int * n)(*(f.shape[2] for f in feats)),
            (ctypes.c_float * n)(*map(float, scales)),
            None if trig is None else trig.data_ptr(), feats[0].shape[0],
            feats[0].shape[-1], points, int(bool(transpose_quirk)),
            _ext.current_stream(feats[0].device))


def frm_sample_levels_bwd_cuda(grads, rois, scales, points=1,
                               transpose_quirk=True, trig=None):
    """Launch K2's backward once for every level of a stage (CUDA tensors):
    ``dfeat = bf16(g + S^T g)`` a level, from the output gradients
    ``grads`` ((B, H, W, C) bf16, contiguous) and the forward's ``rois``,
    ``scales`` and, for points=5, its ``trig`` (taken again when None)."""
    n = len(grads)
    if not 1 <= n <= MAX_LEVELS or not len(rois) == len(scales) == n:
        raise ValueError(f'1 to {MAX_LEVELS} levels, each with a gradient, '
                         f'rois and a scale; got {n}, {len(rois)} and '
                         f'{len(scales)}')
    if points not in (1, 5):
        raise ValueError('points must be 1 or 5')
    dev = grads[0].device
    b, c = grads[0].shape[0], grads[0].shape[-1]
    for g, r in zip(grads, rois):
        _check_level(g, g, r, dev, b, c)
    _check_cuda(dev)
    if points == 5 and trig is None:
        trig = angle_trig(rois)
    # one zeroed buffer: each level's f32 sums (a multiple of 8 floats
    # each, so every level starts 16-byte aligned), then the grid
    # barrier's counter in the last 16 bytes
    sizes = [g.numel() for g in grads]
    buf = torch.zeros(sum(sizes) + 4, dtype=torch.float32, device=dev)
    accs = list(torch.split(buf[:-4], sizes))
    barrier = buf[-4:].view(torch.int32)
    dfeats = [torch.empty_like(g) for g in grads]

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    _ext.launch('frm_sample_bwd', n, ptrs(grads), ptrs(rois), ptrs(accs),
                ptrs(dfeats), (ctypes.c_int * n)(*(g.shape[1] for g in grads)),
                (ctypes.c_int * n)(*(g.shape[2] for g in grads)),
                (ctypes.c_float * n)(*map(float, scales)),
                None if trig is None else trig.data_ptr(),
                barrier.data_ptr(), b, c, points, int(bool(transpose_quirk)),
                _ext.current_stream(dev))
    return dfeats


def frm_sample_levels_bwd_reference(grads, rois, scales, points=1,
                                    transpose_quirk=True):
    """Plain version of :func:`frm_sample_levels_bwd_cuda`: ``dfeat`` of
    every level by autograd through :func:`frm_sample_levels_reference`,
    in the gradients' dtype (the sample is linear in ``feat``, so its
    values do not matter: zeros stand in for them)."""
    with torch.enable_grad():
        feats = [torch.zeros_like(g, requires_grad=True) for g in grads]
        outs = frm_sample_levels_reference(
            [torch.zeros_like(g) for g in grads], feats, rois, scales, points,
            transpose_quirk)
        return list(torch.autograd.grad(outs, feats, grads))


class FRMSampleLevels(torch.autograd.Function):
    """K2 with its backward: ``apply(rois, scales, points, quirk, *xs,
    *feats)`` -> the levels' outputs. Forward: one launch of the K2 kernel;
    backward: ``dx = g`` (the gradient itself, no copy) and ``dfeat`` by one
    launch of K2's backward kernel."""

    @staticmethod
    def forward(ctx, rois, scales, points, transpose_quirk, *tensors):
        n = len(tensors) // 2
        xs, feats = list(tensors[:n]), list(tensors[n:])
        trig = angle_trig(rois) if points == 5 else None
        outs = frm_sample_levels_cuda(xs, feats, rois, scales, points,
                                      transpose_quirk, trig=trig)
        ctx.meta = (rois, scales, points, transpose_quirk, trig)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        rois, scales, points, quirk, trig = ctx.meta
        dfeats = frm_sample_levels_bwd_cuda(
            [g.contiguous() for g in grads], rois, scales, points, quirk,
            trig)
        return (None, None, None, None, *grads, *dfeats)


def frm_sample(x, feat, rois, spatial_scale, transpose_quirk=True):
    """FRM points=1 refinement of one level: ``x + (feat + sample)``.

    x, feat: (B, H, W, C) NHWC; rois: (B, H*W, 5) f32 best boxes in image
    coordinates; ``spatial_scale`` = 1 / stride. CPU tensors take the plain
    form; CUDA tensors launch the kernel, which takes bfloat16 only.
    """
    if feat.is_cuda:
        return frm_sample_cuda(x, feat, rois, spatial_scale, transpose_quirk)
    return frm_sample_reference(x, feat, rois, spatial_scale, transpose_quirk)


def frm_sample_levels(xs, feats, rois, scales, points=1, transpose_quirk=True):
    """FRM refinement of every level of a stage, ``x + (feat + acc)`` a
    level: lists of (B, H, W, C) NHWC ``xs`` and ``feats``, (B, H*W, 5) f32
    ``rois`` and ``scales`` (1 / stride). CPU tensors take the plain form;
    CUDA tensors launch the kernel once for all levels (bfloat16 only),
    through :class:`FRMSampleLevels`, whose backward is K2's backward
    kernel."""
    if feats[0].is_cuda:
        return list(FRMSampleLevels.apply(rois, scales, points,
                                          transpose_quirk, *xs, *feats))
    return frm_sample_levels_reference(xs, feats, rois, scales, points,
                                       transpose_quirk)
