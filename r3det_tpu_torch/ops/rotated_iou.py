"""Rotated-box IoU: the plain PyTorch form and the CUDA tile kernel (K1).

Port of ``r3det_tpu/ops/rotated_iou.py`` (plane form: ``_corner_planes``,
``_half_plane_clip_t``, ``_edges_in_quad_integral``, ``_overlap_planes``,
``rotated_iou_pairwise``, ``negate_theta``) and of the TPU kernel
``r3det_tpu/ops/pallas_iou.py::rotated_iou_pallas``, whose CUDA counterpart
is ``csrc/rotated_iou.cu``.

The intersection area is the Gauss-Green boundary integral: each quad's
edges are clipped Liang-Barsky style to the other quad and contribute
``(t_hi - t_lo) * cross(P, D)``; the second pass rejects edges lying ON the
clip edge (``strict``), so a shared boundary counts once. Each pair is
centred at the mean of its two centres first, for f32 precision at image
scale. Everything is f32.

:func:`rotated_iou` is the batched entry point NMS uses: ``(B, N, 5) x
(B, M, 5) -> (B, N, M)`` with the kernel's ``upper_only`` / ``valid_count``
zero-fill rules. It launches the kernel where :func:`refusal` holds
(``ops/route.py``) and computes the plain form otherwise.

The config-facing API of ``r3det_tpu/ops/rotated_iou.py`` is here too:
:func:`rbbox_overlaps` (pairwise through :func:`rotated_iou`),
:func:`rotated_iou_aligned` and :func:`quad_iou_pairwise` (plain torch
ops on any device, as the JAX package computes them in jnp).
"""
import torch

from .. import _ext
from . import route

EPS_AREA = 1e-14
TILE_R = 8          # pair-tile rows for small problems
TILE_R_LARGE = 64   # pair-tile rows from 256 rows on (the TPU kernel's rule)
TILE_C = 128        # pair-tile columns
ROW_CHUNK = 256     # rows per chunk of the plain form's plane temporaries
CULL_MARGIN = 1.0 + 2.0 ** -10   # K1's relative margin on d^2 (exact in f32)


def _corner_planes(cx, cy, w, h, t):
    """Five (*S,) planes -> two (4, *S) corner planes (tl, tr, br, bl)."""
    c, s = torch.cos(t), torch.sin(t)
    shp = (4,) + (1,) * cx.dim()
    sign_x = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=cx.dtype,
                          device=cx.device).reshape(shp)
    sign_y = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=cx.dtype,
                          device=cx.device).reshape(shp)
    dx = sign_x * w
    dy = sign_y * h
    return c * dx - s * dy + cx, s * dx + c * dy + cy


def _edges_in_quad_integral(ax, ay, bx, by, strict):
    """Sum over A's edges of the part inside quad B, integrated
    (Gauss-Green); quads are (4, *S) CCW corner planes."""
    axn, ayn = ax.roll(-1, 0), ay.roll(-1, 0)
    bxn, byn = bx.roll(-1, 0), by.roll(-1, 0)
    total = None
    for i in range(4):
        px, py = ax[i], ay[i]
        dx, dy = axn[i] - px, ayn[i] - py
        t_lo = torch.zeros_like(px)
        t_hi = torch.ones_like(px)
        for j in range(4):
            ex = bxn[j] - bx[j]
            ey = byn[j] - by[j]
            c0 = ex * (py - by[j]) - ey * (px - bx[j])
            dc = ex * dy - ey * dx
            par = dc.abs() < 1e-12
            t_x = -c0 / torch.where(par, torch.ones_like(dc), dc)
            t_lo = torch.where(~par & (dc > 0), torch.maximum(t_lo, t_x), t_lo)
            t_hi = torch.where(~par & (dc < 0), torch.minimum(t_hi, t_x), t_hi)
            reject = (c0 <= 0) if strict else (c0 < 0)
            t_hi = torch.where(par & reject, torch.full_like(t_hi, -1.0), t_hi)
        span = (t_hi - t_lo).clamp_min(0.0)
        term = span * (px * dy - py * dx)
        total = term if total is None else total + term
    return total


def _quad_intersect_area(ax, ay, bx, by):
    """Intersection area of CCW convex quads in plane form: (4, *S) x 4
    -> (*S): A's edges inside B, then B's edges strictly inside A."""
    s1 = _edges_in_quad_integral(ax, ay, bx, by, strict=False)
    s2 = _edges_in_quad_integral(bx, by, ax, ay, strict=True)
    return (s1 + s2).abs() * 0.5


def _overlap_planes(b1, b2, mode):
    """IoU/IoF of broadcast-shaped box planes: b1, b2 are 5-tuples."""
    cx1, cy1, w1, h1, t1 = b1
    cx2, cy2, w2, h2, t2 = b2
    mx = (cx1 + cx2) * 0.5
    my = (cy1 + cy2) * 0.5
    ax, ay = _corner_planes(cx1 - mx, cy1 - my, w1, h1, t1)
    bx, by = _corner_planes(cx2 - mx, cy2 - my, w2, h2, t2)
    inter = _quad_intersect_area(ax, ay, bx, by)
    area1 = w1 * h1
    area2 = w2 * h2
    if mode == 'iou':
        denom = area1 + area2 - inter
    else:
        denom = area1.expand_as(inter)
    return inter / denom.clamp_min(EPS_AREA)


def rotated_iou_pairwise(boxes1, boxes2, mode='iou'):
    """Dense rotated IoU/IoF, plain form: ``(..., N, 5) x (..., M, 5) ->
    (..., N, M)`` f32 (leading dims broadcast). Rows go in chunks of
    ``ROW_CHUNK`` to bound the plane temporaries."""
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    if n == 0 or m == 0:
        return boxes1.new_zeros(lead + (n, m))
    f2 = tuple(boxes2[..., None, :, i] for i in range(5))       # (..., 1, M)
    chunks = []
    for r0 in range(0, n, ROW_CHUNK):
        rows = boxes1[..., r0:r0 + ROW_CHUNK, :]
        f1 = tuple(rows[..., :, None, i] for i in range(5))     # (..., R, 1)
        shape = torch.broadcast_shapes(f1[0].shape, f2[0].shape)
        chunks.append(_overlap_planes(
            tuple(a.expand(shape) for a in f1),
            tuple(a.expand(shape) for a in f2), mode))
    return torch.cat(chunks, dim=-2)


def tile_rows(n):
    """Pair-tile height of the zero-fill rules for an n-row problem."""
    return TILE_R_LARGE if n >= 256 else TILE_R


def _skip_mask(n, m, upper_only, valid_count, device):
    """(B or 1, N, M) bool: pairs the kernel zero-fills, at tile
    granularity (``pallas_iou.py:82-123``)."""
    tr = tile_rows(n)
    row0 = (torch.arange(n, device=device) // tr * tr)[:, None]
    col0 = (torch.arange(m, device=device) // TILE_C * TILE_C)[None, :]
    skip = torch.zeros((1, n, m), dtype=torch.bool, device=device)
    if upper_only:
        skip = skip | (row0 >= col0 + TILE_C)[None]
    if valid_count is not None:
        v = valid_count.to(device=device, dtype=torch.int64)[:, None, None]
        skip = skip | (row0[None] >= v) | (col0[None] >= v)
    return skip


def rotated_iou_reference(boxes1, boxes2, mode='iou', upper_only=False,
                          valid_count=None):
    """Plain version of :func:`rotated_iou`: same signature and result."""
    iou = rotated_iou_pairwise(boxes1, boxes2, mode)
    if upper_only or valid_count is not None:
        skip = _skip_mask(iou.shape[-2], iou.shape[-1], upper_only,
                          valid_count, iou.device)
        iou = iou.masked_fill(skip, 0.0)
    return iou


def refusal(boxes1, boxes2):
    """K1's contract (``ops/route.py``): float32 boxes."""
    f32 = torch.float32
    return route.refusal(boxes2, boxes2.dtype, want=f32) or \
        route.refusal(boxes1, boxes1.dtype, boxes1, boxes2, want=f32)


def rotated_iou_cuda(boxes1, boxes2, mode='iou', upper_only=False,
                     valid_count=None):
    """Launch the K1 kernel (``csrc/rotated_iou.cu``) on CUDA tensors."""
    route.check(refusal(boxes1, boxes2), 'rotated_iou')
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    for name, t in (('boxes1', boxes1), ('boxes2', boxes2)):
        if t.dim() != 3 or t.shape[-1] != 5 or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous (B, K, 5) '
                             f'tensor, got {tuple(t.shape)}')
    b, n, _ = boxes1.shape
    if boxes2.shape[0] != b or boxes2.device != boxes1.device:
        raise ValueError('boxes1 and boxes2 must share batch size and device')
    m = boxes2.shape[1]
    vptr = None
    if valid_count is not None:
        if not valid_count.is_cuda or valid_count.dtype != torch.int32 \
                or tuple(valid_count.shape) != (b,) \
                or valid_count.device != boxes1.device:
            raise ValueError('valid_count must be a (B,) int32 tensor on the '
                             'boxes\' device')
        vptr = valid_count.data_ptr()
    out = torch.empty((b, n, m), dtype=torch.float32, device=boxes1.device)
    _ext.launch('rotated_iou', boxes1.data_ptr(), boxes2.data_ptr(), vptr,
                out.data_ptr(), b, n, m, int(mode == 'iof'),
                int(bool(upper_only)), tile_rows(n), TILE_C,
                _ext.current_stream(boxes1.device))
    return out


def rotated_iou(boxes1, boxes2, mode='iou', upper_only=False,
                valid_count=None):
    """Batched dense rotated IoU/IoF ``(B, N, 5) x (B, M, 5) -> (B, N, M)``.

    ``upper_only`` zero-fills pair tiles strictly below the diagonal (greedy
    NMS reads j < i pairs only); ``valid_count`` ((B,) int32) zero-fills
    tiles past each image's live prefix. The kernel where :func:`refusal`
    holds, the plain form otherwise.
    """
    if refusal(boxes1, boxes2) is None:
        return rotated_iou_cuda(boxes1, boxes2, mode, upper_only, valid_count)
    return rotated_iou_reference(boxes1, boxes2, mode, upper_only,
                                 valid_count)


def rotated_iou_aligned(boxes1, boxes2, mode='iou'):
    """Elementwise IoU/IoF of aligned boxes ``(N, 5) x (N, 5) -> (N,)``,
    plain torch ops on any device (the JAX package computes it in jnp,
    outside any kernel)."""
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    if boxes1.shape[0] == 0:
        return boxes1.new_zeros((0,))
    return _overlap_planes(tuple(boxes1[:, i] for i in range(5)),
                           tuple(boxes2[:, i] for i in range(5)), mode)


def _quad_area(q):
    """Shoelace area of (N, 8) quads (x0, y0, ..., x3, y3) -> (N,)."""
    x, y = q[:, 0::2], q[:, 1::2]
    return (x * y.roll(-1, 1) - x.roll(-1, 1) * y).sum(1).abs() * 0.5


def quad_iou_pairwise(quads1, quads2):
    """Dense IoU of convex quads ``(N, 8) x (M, 8) -> (N, M)`` (CCW
    corners, as ``obb2poly`` gives them), plain torch ops on any device;
    rows go in chunks of ``ROW_CHUNK``. poly_nms's IoU."""
    quads1 = quads1.float()
    quads2 = quads2.float()
    n, m = quads1.shape[0], quads2.shape[0]
    if n == 0 or m == 0:
        return quads1.new_zeros((n, m))
    bx = quads2[:, 0::2].T[:, None, :]                       # (4, 1, M)
    by = quads2[:, 1::2].T[:, None, :]
    a2 = _quad_area(quads2)[None, :]
    chunks = []
    for r0 in range(0, n, ROW_CHUNK):
        rows = quads1[r0:r0 + ROW_CHUNK]
        r = rows.shape[0]
        ax = rows[:, 0::2].T[:, :, None].expand(4, r, m)
        ay = rows[:, 1::2].T[:, :, None].expand(4, r, m)
        inter = _quad_intersect_area(ax, ay, bx.expand(4, r, m),
                                     by.expand(4, r, m))
        a1 = _quad_area(rows)[:, None]
        chunks.append(inter / (a1 + a2 - inter).clamp_min(EPS_AREA))
    return torch.cat(chunks, 0)


def rbbox_overlaps(bboxes1, bboxes2, mode='iou', is_aligned=False,
                   small_box_thr=None, negate_angle=False):
    """The IoU calculators' entry: ``(N, 5[+score]) x (M, 5[+score]) ->
    (N, M)``, or ``(N,)`` when ``is_aligned``.

    A 6th (score) column is trimmed; ``negate_angle`` takes the
    detectron2/mmcv angle convention (:func:`negate_theta`); boxes with
    min(w, h) below ``small_box_thr`` get overlap 0. The pairwise form is
    :func:`rotated_iou` on a batch of 1 (K1 where it takes the boxes),
    the aligned form plain torch ops.
    """
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    if bboxes1.shape[-1] == 6:
        bboxes1 = bboxes1[..., :5]
    if bboxes2.shape[-1] == 6:
        bboxes2 = bboxes2[..., :5]
    if negate_angle:
        bboxes1 = negate_theta(bboxes1)
        bboxes2 = negate_theta(bboxes2)
    if small_box_thr is not None:
        tiny1 = torch.minimum(bboxes1[:, 2], bboxes1[:, 3]) < small_box_thr
        tiny2 = torch.minimum(bboxes2[:, 2], bboxes2[:, 3]) < small_box_thr
    if is_aligned:
        out = rotated_iou_aligned(bboxes1, bboxes2, mode=mode)
        if small_box_thr is not None:
            out = out.masked_fill(tiny1 | tiny2, 0.0)
        return out
    if bboxes1.shape[0] == 0 or bboxes2.shape[0] == 0:
        return bboxes1.new_zeros((bboxes1.shape[0], bboxes2.shape[0]),
                                 dtype=torch.float32)
    out = rotated_iou(bboxes1.float().contiguous()[None],
                      bboxes2.float().contiguous()[None], mode=mode)[0]
    if small_box_thr is not None:
        out = out.masked_fill(tiny1[:, None] | tiny2[None, :], 0.0)
    return out


def _circumradius(boxes):
    """0.5 * sqrt(w^2 + h^2) per box, f32; NaN where any of the box's five
    values is NaN or inf."""
    w, h = boxes[..., 2], boxes[..., 3]
    r = 0.5 * torch.sqrt(w * w + h * h)
    return torch.where(torch.isfinite(boxes).all(-1), r,
                       torch.full_like(r, float('nan')))


def far_pairs(boxes1, boxes2):
    """K1's cull predicate, plain form: ``(..., N, 5) x (..., M, 5) ->
    (..., N, M)`` bool, True where the kernel stores 0 without the integral.

    Far means ``d^2 > (r1 + r2)^2 * CULL_MARGIN`` with ``d^2`` finite, on
    the raw centres, in f32 and in the kernel's order of operations
    (``csrc/rotated_iou.cu``, pass 2). A box with a NaN or inf value has a
    NaN radius, so its pairs are never far.
    """
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    dx = boxes2[..., None, :, 0] - boxes1[..., :, None, 0]
    dy = boxes2[..., None, :, 1] - boxes1[..., :, None, 1]
    d2 = dx * dx + dy * dy
    sr = _circumradius(boxes1)[..., :, None] + \
        _circumradius(boxes2)[..., None, :]
    return (d2 > sr * sr * CULL_MARGIN) & (d2 < float('inf'))


def negate_theta(boxes):
    """Flip a box set to the detectron2/mmcv angle convention (the v2/v3
    reference kernels rotate with the opposite sign)."""
    return torch.cat([boxes[..., :4], -boxes[..., 4:5]], dim=-1)
