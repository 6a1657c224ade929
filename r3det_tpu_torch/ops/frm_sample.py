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
``S^T`` sending each cell's gradient, times the f32 weights of the
corners its points read, onto those corners, by one launch of K2's
backward kernel for all levels (:func:`frm_sample_levels_bwd_cuda`). The
kernel gathers each corner's contributions in a fixed order, with no
atomics on the sums, so it is deterministic and bit-equal to
:func:`frm_sample_levels_bwd_ordered`, the plain form of that order. The
autograd form through :func:`frm_sample_levels_reference`
(:func:`frm_sample_levels_bwd_reference`) is the backward as the JAX
package differentiates it; it rounds otherwise, so the kernel is held to
it within a bound.
"""
import ctypes

import torch

from .. import _ext

MAX_LEVELS = 8            # levels of one kernel launch
# K2's backward: a corner row with more contributions than this sums them
# in chunks of this many (csrc/frm_sample.cu kChunk)
BWD_CHUNK = 256
_BWD_MAX_GRID = 1024      # csrc/frm_sample.cu kMaxGrid
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
    inside, idx, wts = corner_setup(py, px, h, w)
    flat = feat.reshape(b, h * w, c)

    def corner(k):
        return flat.gather(1, idx[..., k, None].expand(-1, -1, c)).float()

    val = (wts[..., 0, None] * corner(0) + wts[..., 1, None] * corner(1)
           + wts[..., 2, None] * corner(2) + wts[..., 3, None] * corner(3))
    val = torch.where(inside[..., None], val, torch.zeros_like(val))
    return val.to(feat.dtype)


def corner_setup(py, px, h, w):
    """The bilinear setup of points (row ``py``, col ``px``) on an h x w
    map: (inside (..), the 4 corners' flat indices y * w + x (.., 4) and
    their f32 weights (.., 4)), corners in the order y0x0, y0x1, y1x0,
    y1x1. Points outside (-1, h) x (-1, w) sample nothing; inside,
    coordinates clamp to the map."""
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
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                      -1)
    wts = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], -1)
    return inside, idx, wts


def sample_coords(rois, spatial_scale, transpose_quirk=True):
    """(row, col) sample points (B, H*W) of the rois' centres on a level."""
    cx = rois[..., 0] * spatial_scale
    cy = rois[..., 1] * spatial_scale
    return (cx, cy) if transpose_quirk else (cy, cx)


def sample_points(best_bboxes, spatial_scale, points=1,
                  transpose_quirk=True, trig=None):
    """The (row, col) sample points of every cell, one pair a point: the
    box centre, then for points=5 its four corners p1..p4. ``trig`` (2,
    B, H*W): the cos and sin of the box angles, taken here when None."""
    if points not in (1, 5):
        raise ValueError('points must be 1 or 5')
    out = [sample_coords(best_bboxes, spatial_scale, transpose_quirk)]
    if points == 5:
        cx = best_bboxes[..., 0] * spatial_scale
        cy = best_bboxes[..., 1] * spatial_scale
        bw = best_bboxes[..., 2] * spatial_scale
        bh = best_bboxes[..., 3] * spatial_scale
        if trig is None:
            a = best_bboxes[..., 4]
            cosa, sina = torch.cos(a), torch.sin(a)
        else:
            cosa, sina = trig[0], trig[1]
        wx, wy = cosa * bw / 2, sina * bw / 2
        hx, hy = -sina * bh / 2, cosa * bh / 2
        for sw, sh in CORNER_SIGNS:
            dx = sw * wx + sh * hx
            dy = sw * wy + sh * hy
            out.append((cx + dy, cy + dx) if transpose_quirk
                       else (cy + dy, cx + dx))
    return out


def feature_refine_sample(feat, best_bboxes, spatial_scale, points=1,
                          transpose_quirk=True):
    """FR op of one level, plain form: feat (B, H, W, C), best_bboxes
    (B, H*W, 5) -> feat + the sum of bilinear samples at the box points."""
    b, h, w, c = feat.shape
    acc = None
    for r, cc in sample_points(best_bboxes, spatial_scale, points,
                               transpose_quirk):
        val = bilinear_sample(feat, r, cc).reshape(b, h, w, c)
        acc = val if acc is None else acc + val
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


def bwd_workspace(cells, points, device):
    """The two int32 workspaces of K2's backward for ``cells`` rows (B *
    sum(H * W) over the levels): (zeroed, ws), in the layout of
    csrc/frm_sample.cu's make_work. zeroed holds a count a row, the grid
    barrier's counter and the long-row count (all 0); ws the row offsets,
    block sums and long rows, and 3 ints a contribution slot (4 * points
    slots a row: corner row, weight, CSR id)."""
    def round4(n):
        return (n + 3) // 4 * 4
    slots = 4 * points * cells
    zeroed = torch.zeros(round4(cells) + 20, dtype=torch.int32,
                         device=device)
    ws = torch.empty(round4(cells + 1) + _BWD_MAX_GRID + round4(cells)
                     + 3 * slots, dtype=torch.int32, device=device)
    return zeroed, ws


def bwd_args(grads, rois, dfeats, scales, trig, zeroed, ws, points,
             transpose_quirk):
    """The arguments of the C entry point ``r3det_frm_sample_bwd`` for
    checked levels."""
    n = len(grads)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    return (n, ptrs(grads), ptrs(rois), ptrs(dfeats),
            (ctypes.c_int * n)(*(g.shape[1] for g in grads)),
            (ctypes.c_int * n)(*(g.shape[2] for g in grads)),
            (ctypes.c_float * n)(*map(float, scales)),
            None if trig is None else trig.data_ptr(), zeroed.data_ptr(),
            zeroed.numel(), ws.data_ptr(), ws.numel(), grads[0].shape[0],
            grads[0].shape[-1], points, int(bool(transpose_quirk)),
            _ext.current_stream(grads[0].device))


def frm_sample_levels_bwd_cuda(grads, rois, scales, points=1,
                               transpose_quirk=True, trig=None):
    """Launch K2's backward once for every level of a stage (CUDA tensors):
    ``dfeat = bf16(g + S^T g)`` a level, from the output gradients
    ``grads`` ((B, H, W, C) bf16, contiguous) and the forward's ``rois``,
    ``scales`` and, for points=5, its ``trig`` (taken again when None).
    Deterministic: bit-equal to :func:`frm_sample_levels_bwd_ordered`."""
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
    cells = sum(g.shape[0] * g.shape[1] * g.shape[2] for g in grads)
    zeroed, ws = bwd_workspace(cells, points, dev)
    dfeats = [torch.empty_like(g) for g in grads]
    _ext.launch('frm_sample_bwd', *bwd_args(
        grads, rois, dfeats, scales, trig, zeroed, ws, points,
        transpose_quirk))
    return dfeats


def bwd_contributions(rois, spatial_scale, h, w, points=1,
                      transpose_quirk=True, trig=None):
    """Every contribution of one level's backward, in the order e = ((cell
    * points) + q) * 4 + k (cell = b * H * W + i * W + j, q the point, k the
    corner y0x0, y0x1, y1x0, y1x1): (rows, weights), rows (B*H*W*points*4,)
    int64, the corner's row b * H * W + y * W + x, or -1 where the point is
    outside; weights the f32 corner weights (0 outside)."""
    b = rois.shape[0]
    pts = sample_points(rois, spatial_scale, points, transpose_quirk, trig)
    rows, wts = [], []
    for r, c in pts:
        inside, idx, wt = corner_setup(r, c, h, w)
        base = (torch.arange(b, device=idx.device) * (h * w))[:, None, None]
        rows.append(torch.where(inside[..., None], idx + base, -1))
        wts.append(torch.where(inside[..., None], wt, 0.0))
    # (B, H*W, points, 4) -> flat in e order
    return (torch.stack(rows, 2).reshape(-1),
            torch.stack(wts, 2).reshape(-1))


def frm_sample_levels_bwd_ordered(grads, rois, scales, points=1,
                                  transpose_quirk=True, trig=None,
                                  chunk=BWD_CHUNK):
    """The plain form of K2's backward kernel, its summation order
    included (CPU tensors): ``dfeat = (g + acc).to(g.dtype)`` a level, acc
    in f32. Each corner row sums the f32 products w * g_cell of its
    contributions (:func:`bwd_contributions`) in ascending e from +0.0,
    each product rounded and then added; a row of more than ``chunk``
    contributions sums consecutive chunks of ``chunk`` of them from +0.0
    each and then the chunk sums in order from +0.0. ``Tensor.index_add_``
    on the CPU adds its source rows in index order, which is that order.
    ``trig`` (2, cells): the forward's cos and sin of every level's angles
    (points=5; taken here when None). Works 32 channels at a time, so the
    products of points=5 at training shapes fit in host memory."""
    if points == 5 and trig is None:
        trig = angle_trig(rois)
    out, begin = [], 0
    for g, r, s in zip(grads, rois, scales):
        b, h, w, c = g.shape
        n = b * h * w
        t = None if trig is None else \
            trig[:, begin:begin + n].reshape(2, b, h * w)
        begin += n
        key, wt = bwd_contributions(r, s, h, w, points, transpose_quirk, t)
        src = torch.arange(key.numel()) // (4 * points)
        keep = key >= 0
        key, wt, src = key[keep], wt[keep], src[keep]
        # each contribution's place in its row's ascending-e list, its
        # chunk, and the chunks' slots (a row's chunks in order)
        count = torch.bincount(key, minlength=n)
        order = torch.sort(key, stable=True).indices
        start = torch.cumsum(count, 0) - count
        place = torch.empty_like(key)
        place[order] = torch.arange(key.numel()) - start[key[order]]
        chunks = (count + chunk - 1) // chunk
        part_of = (torch.cumsum(chunks, 0) - chunks)[key] + place // chunk
        part_row = torch.repeat_interleave(torch.arange(n), chunks)
        flat = g.reshape(n, c)
        res = torch.empty_like(flat)
        for c0 in range(0, c, 32):
            c1 = min(c, c0 + 32)
            prod = wt[:, None] * flat[src, c0:c1].float()
            part = torch.zeros(part_row.numel(), c1 - c0).index_add_(
                0, part_of, prod)
            acc = torch.zeros(n, c1 - c0).index_add_(0, part_row, part)
            res[:, c0:c1] = (flat[:, c0:c1].float() + acc).to(g.dtype)
        out.append(res.reshape(g.shape))
    return out


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
