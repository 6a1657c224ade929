"""Box arithmetic of the reference: anchors, the v1 delta coder, the
rotated IoU and the axis-aligned IoU, in float32.

The configurations use the v1 angle convention and oriented anchors
(``DeltaXYWHAOBBoxCoder`` with angle_range v1); anything else raises.
The rotated IoU is the Gauss-Green boundary integral of the two quads
(each edge clipped to the other quad, Liang-Barsky style, shared edges
counted once), each pair centred at the mean of its centres, in the
operation order of the program's plain form, so that it gives the same
float32 values. The greedy NMS of ``predict.py`` thresholds these values,
and a pair at the threshold would otherwise decide differently.
"""
import math

import numpy as np
import torch

EPS_AREA = 1e-14
ROW_CHUNK = 256


def _check(cfg):
    if cfg['angle_version'] != 'v1' or cfg.get('hbb_anchors'):
        raise NotImplementedError('the reference covers angle v1 with '
                                  'oriented anchors')


def base_anchors(stride, cfg):
    ratios = np.asarray(cfg['ratios'], np.float64)
    spo = cfg['scales_per_octave']
    scales = cfg['octave_base_scale'] * np.array(
        [2 ** (i / spo) for i in range(spo)])
    hr = np.sqrt(ratios)
    wr = 1.0 / hr
    ws = (stride * wr[:, None] * scales[None, :]).reshape(-1)
    hs = (stride * hr[:, None] * scales[None, :]).reshape(-1)
    return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], -1)


def grid_anchors(cfg, featmap_sizes, device=None):
    """Per level (H*W*A, 5) anchors (cx, cy, w, h, 0), position-major."""
    _check(cfg)
    out = []
    for (h, w), stride in zip(featmap_sizes, cfg['strides']):
        base = base_anchors(stride, cfg)
        sx = np.arange(w, dtype=np.float64) * stride
        sy = np.arange(h, dtype=np.float64) * stride
        shift = np.stack(np.meshgrid(sx, sy), -1).reshape(-1, 2)
        xyxy = (base[None] + np.tile(shift, 2)[:, None]).reshape(-1, 4)
        a = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                            xyxy[:, 2:] - xyxy[:, :2],
                            np.zeros((len(xyxy), 1))], -1)
        out.append(torch.from_numpy(a.astype(np.float32)).to(device))
    return out


def encode(proposals, gt, cfg):
    """v1 deltas of ``gt`` against ``proposals`` (means 0, stds 1)."""
    _check(cfg)
    px, py, pw, ph, pa = proposals.unbind(-1)
    gx, gy, gw, gh, ga = gt.unbind(-1)
    d = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                     torch.log(gh / ph), ga - pa], -1)
    means = d.new_tensor(cfg['target_means'])
    stds = d.new_tensor(cfg['target_stds'])
    return (d - means) / stds


def decode(rois, deltas, cfg, max_shape=None, wh_ratio_clip=16 / 1000):
    """v1 decode with the w/h ratio clip and the optional centre clamp to
    ``max_shape`` (h, w)."""
    _check(cfg)
    d = deltas * deltas.new_tensor(cfg['target_stds']) + \
        deltas.new_tensor(cfg['target_means'])
    dx, dy, dw, dh, da = d.unbind(-1)
    px, py, pw, ph, pa = rois.unbind(-1)
    m = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-m, m)
    dh = dh.clamp(-m, m)
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    ga = pa + da
    if max_shape is not None:
        gx = gx.clamp(0, max_shape[1] - 1)
        gy = gy.clamp(0, max_shape[0] - 1)
    return torch.stack([gx, gy, gw, gh, ga], -1)


def obb2xyxy_v1(rb):
    cx, cy, w, h, a = rb.unbind(-1)
    c, s = torch.cos(a), torch.sin(a)
    hw = c * w - s * h
    hh = -s * w + c * h
    return torch.stack([cx - hw / 2, cy - hh / 2, cx + hw / 2, cy + hh / 2],
                       -1)


def circum_xyxy_v1(rb):
    """The v1 circumscribed box of R3Det's base-head assignment (the
    reference's obb2hbb with its w/h slot swap and theta -pi/2), as xyxy."""
    cx, cy, w, h, a = rb.unbind(-1)
    c, s = torch.cos(a), torch.sin(a)
    hw = c * w - s * h
    hh = -s * w + c * h
    return obb2xyxy_v1(torch.stack([cx, cy, hh, hw,
                                    torch.full_like(a, -math.pi / 2)], -1))


def hbb_iou(b1, b2):
    """(..., G, 4) x (..., A, 4) xyxy -> (..., G, A)."""
    x11, y11, x12, y12 = [b1[..., :, None, i] for i in range(4)]
    x21, y21, x22, y22 = [b2[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp_min(0.0)
    ih = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp_min(0.0)
    inter = iw * ih
    a1 = (x12 - x11).clamp_min(0.0) * (y12 - y11).clamp_min(0.0)
    a2 = (x22 - x21).clamp_min(0.0) * (y22 - y21).clamp_min(0.0)
    return inter / (a1 + a2 - inter).clamp_min(1e-10)


def _corners(cx, cy, w, h, t):
    c, s = torch.cos(t), torch.sin(t)
    shp = (4,) + (1,) * cx.dim()
    sx = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=cx.dtype,
                      device=cx.device).reshape(shp)
    sy = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=cx.dtype,
                      device=cx.device).reshape(shp)
    dx = sx * w
    dy = sy * h
    return c * dx - s * dy + cx, s * dx + c * dy + cy


def _edges_inside(ax, ay, bx, by, strict):
    axn, ayn = ax.roll(-1, 0), ay.roll(-1, 0)
    bxn, byn = bx.roll(-1, 0), by.roll(-1, 0)
    total = None
    for i in range(4):
        px, py = ax[i], ay[i]
        dx, dy = axn[i] - px, ayn[i] - py
        lo = torch.zeros_like(px)
        hi = torch.ones_like(px)
        for j in range(4):
            ex = bxn[j] - bx[j]
            ey = byn[j] - by[j]
            c0 = ex * (py - by[j]) - ey * (px - bx[j])
            dc = ex * dy - ey * dx
            par = dc.abs() < 1e-12
            t = -c0 / torch.where(par, torch.ones_like(dc), dc)
            lo = torch.where(~par & (dc > 0), torch.maximum(lo, t), lo)
            hi = torch.where(~par & (dc < 0), torch.minimum(hi, t), hi)
            reject = (c0 <= 0) if strict else (c0 < 0)
            hi = torch.where(par & reject, torch.full_like(hi, -1.0), hi)
        term = (hi - lo).clamp_min(0.0) * (px * dy - py * dx)
        total = term if total is None else total + term
    return total


def _iou_planes(b1, b2):
    cx1, cy1, w1, h1, t1 = b1
    cx2, cy2, w2, h2, t2 = b2
    mx = (cx1 + cx2) * 0.5
    my = (cy1 + cy2) * 0.5
    ax, ay = _corners(cx1 - mx, cy1 - my, w1, h1, t1)
    bx, by = _corners(cx2 - mx, cy2 - my, w2, h2, t2)
    inter = (_edges_inside(ax, ay, bx, by, False)
             + _edges_inside(bx, by, ax, ay, True)).abs() * 0.5
    return inter / (w1 * h1 + w2 * h2 - inter).clamp_min(EPS_AREA)


def rotated_iou(boxes1, boxes2):
    """(..., N, 5) x (..., M, 5) -> (..., N, M) rotated IoU, rows in
    chunks of ROW_CHUNK."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    if n == 0 or m == 0:
        return boxes1.new_zeros(lead + (n, m))
    f2 = tuple(boxes2[..., None, :, i] for i in range(5))
    out = []
    for r0 in range(0, n, ROW_CHUNK):
        rows = boxes1[..., r0:r0 + ROW_CHUNK, :]
        f1 = tuple(rows[..., :, None, i] for i in range(5))
        shape = torch.broadcast_shapes(f1[0].shape, f2[0].shape)
        out.append(_iou_planes(tuple(a.expand(shape) for a in f1),
                               tuple(a.expand(shape) for a in f2)))
    return torch.cat(out, -2)
