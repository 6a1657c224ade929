"""Delta box coders, all three angle conventions.

Port of ``r3det_tpu/core/coders.py``: the oriented-anchor coder
(``obb2delta_v{1,2,3}``, ``delta2obb_v{1,2,3}``, ``DeltaXYWHAOBBoxCoder``,
the reference's delta_xywha_rbbox_coder.py) and the horizontal-anchor
coder (``hbb2delta_v{1,2,3}``, ``delta2hbb_obb_v{1,2,3}``,
``DeltaXYWHAHBBoxCoder``, delta_xywha_hbbox_coder.py: anchors (..., 4)
xyxy, targets and decoded boxes (..., 5)). Pure tensor functions; ``%`` on
tensors is Python's floored modulo, as ``jnp``'s is, so the angle folds
carry over unchanged.
"""
import math
from typing import Sequence, Tuple

import torch

PI = math.pi
DEFAULT_MEANS = (0., 0., 0., 0., 0.)
DEFAULT_STDS = (1., 1., 1., 1., 1.)


def _normalize(deltas, means, stds):
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def _denormalize(deltas, means, stds):
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return deltas * stds + means


def _unpack5(b):
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3], b[..., 4]


def _hbb_center(b):
    """(cx, cy, w, h) of xyxy boxes (reads the first four columns)."""
    return ((b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


def obb2delta_v1(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """Plain offsets; da = ga - pa."""
    px, py, pw, ph, pa = _unpack5(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph), ga - pa],
                         dim=-1)
    return _normalize(deltas, means, stds)


def delta2obb_v1(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                 max_shape=None, wh_ratio_clip=16 / 1000):
    """v1 decode, with the wh-ratio clip and the optional centre clamp to
    ``max_shape`` (h, w)."""
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    px, py, pw, ph, pa = _unpack5(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    ga = pa + da
    if max_shape is not None:
        gx = gx.clamp(0, max_shape[1] - 1)
        gy = gy.clamp(0, max_shape[0] - 1)
    return torch.stack([gx, gy, gw, gh, ga], dim=-1)


def obb2delta_v2(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """Rotated-frame projection; dtheta folded to [-pi/4, 3pi/4) then /pi."""
    px, py, pw, ph, pa = _unpack5(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    cosp, sinp = torch.cos(pa), torch.sin(pa)
    dx = (cosp * (gx - px) + sinp * (gy - py)) / pw
    dy = (-sinp * (gx - px) + cosp * (gy - py)) / ph
    dtheta = (ga - pa + PI / 4) % PI - PI / 4
    dtheta = dtheta / PI
    deltas = torch.stack([dx, dy, torch.log(gw / pw), torch.log(gh / ph),
                          dtheta], dim=-1)
    return _normalize(deltas, means, stds)


def delta2obb_v2(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                 wh_ratio_clip=16 / 1000):
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    da = da * PI
    px, py, pw, ph, pa = _unpack5(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    cosp, sinp = torch.cos(pa), torch.sin(pa)
    gx = dx * pw * cosp - dy * ph * sinp + px
    gy = dx * pw * sinp + dy * ph * cosp + py
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    ga = (da + pa + PI / 4) % PI - PI / 4
    return torch.stack([gx, gy, gw, gh, ga], dim=-1)


def obb2delta_v3(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """gt regularized to the nearer of {theta, theta + pi/2}; projection by
    R(-pa)."""
    px, py, pw, ph, pa = _unpack5(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    dt1 = (ga - pa + PI / 2) % PI - PI / 2
    dt2 = (ga - pa + PI) % PI - PI / 2
    take1 = dt1.abs() < dt2.abs()
    gw_r = torch.where(take1, gw, gh)
    gh_r = torch.where(take1, gh, gw)
    dtheta = torch.where(take1, dt1, dt2)
    cosp, sinp = torch.cos(-pa), torch.sin(-pa)
    dx = (cosp * (gx - px) + sinp * (gy - py)) / pw
    dy = (-sinp * (gx - px) + cosp * (gy - py)) / ph
    deltas = torch.stack([dx, dy, torch.log(gw_r / pw), torch.log(gh_r / ph),
                          dtheta], dim=-1)
    return _normalize(deltas, means, stds)


def delta2obb_v3(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                 wh_ratio_clip=16 / 1000):
    """Decode + w >= h regularization + angle renormalization."""
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    px, py, pw, ph, pa = _unpack5(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    cosp, sinp = torch.cos(-pa), torch.sin(-pa)
    gx = dx * pw * cosp - dy * ph * sinp + px
    gy = dx * pw * sinp + dy * ph * cosp + py
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gtheta = da + pa
    wide = gw > gh
    w_r = torch.where(wide, gw, gh)
    h_r = torch.where(wide, gh, gw)
    t_r = torch.where(wide, gtheta, gtheta + PI / 2)
    t_r = (t_r + PI / 2) % PI - PI / 2
    return torch.stack([gx, gy, w_r, h_r, t_r], dim=-1)


def hbb2delta_v1(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """da = ga raw."""
    px, py, pw, ph = _hbb_center(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph), ga], dim=-1)
    return _normalize(deltas, means, stds)


def delta2hbb_obb_v1(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                     wh_ratio_clip=16 / 1000):
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    px, py, pw, ph = _hbb_center(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    return torch.stack([px + pw * dx, py + ph * dy, pw * torch.exp(dw),
                        ph * torch.exp(dh), da], dim=-1)


def hbb2delta_v2(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """da = ga / pi."""
    px, py, pw, ph = _hbb_center(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph), ga / PI],
                         dim=-1)
    return _normalize(deltas, means, stds)


def delta2hbb_obb_v2(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                     wh_ratio_clip=16 / 1000):
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    da = da * PI
    px, py, pw, ph = _hbb_center(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    ga = (da + PI / 4) % PI - PI / 4
    return torch.stack([px + pw * dx, py + ph * dy, pw * torch.exp(dw),
                        ph * torch.exp(dh), ga], dim=-1)


def hbb2delta_v3(proposals, gt, means=DEFAULT_MEANS, stds=DEFAULT_STDS):
    """gt regularized against theta = 0; dtheta scaled by 1 / (2 pi)."""
    px, py, pw, ph = _hbb_center(proposals)
    gx, gy, gw, gh, ga = _unpack5(gt)
    dt1 = (ga + PI / 2) % PI - PI / 2
    dt2 = (ga + PI) % PI - PI / 2
    take1 = dt1.abs() < dt2.abs()
    gw_r = torch.where(take1, gw, gh)
    gh_r = torch.where(take1, gh, gw)
    dtheta = torch.where(take1, dt1, dt2) / (2 * PI)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw_r / pw), torch.log(gh_r / ph), dtheta],
                         dim=-1)
    return _normalize(deltas, means, stds)


def delta2hbb_obb_v3(rois, deltas, means=DEFAULT_MEANS, stds=DEFAULT_STDS,
                     wh_ratio_clip=16 / 1000):
    """Decode + w >= h regularization + angle renormalization."""
    d = _denormalize(deltas, means, stds)
    dx, dy, dw, dh, da = _unpack5(d)
    da = da * 2 * PI
    px, py, pw, ph = _hbb_center(rois)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gtheta = (da + PI / 2) % PI - PI / 2
    wide = gw > gh
    w_r = torch.where(wide, gw, gh)
    h_r = torch.where(wide, gh, gw)
    t_r = torch.where(wide, gtheta, gtheta + PI / 2)
    t_r = (t_r + PI / 2) % PI - PI / 2
    return torch.stack([px + pw * dx, py + ph * dy, w_r, h_r, t_r], dim=-1)


_OBB_ENCODE = {'v1': obb2delta_v1, 'v2': obb2delta_v2, 'v3': obb2delta_v3}
_OBB_DECODE = {'v1': delta2obb_v1, 'v2': delta2obb_v2, 'v3': delta2obb_v3}
_HBB_ENCODE = {'v1': hbb2delta_v1, 'v2': hbb2delta_v2, 'v3': hbb2delta_v3}
_HBB_DECODE = {'v1': delta2hbb_obb_v1, 'v2': delta2hbb_obb_v2,
               'v3': delta2hbb_obb_v3}


class DeltaXYWHAOBBoxCoder:
    """OBB(5)-anchor <-> delta(5) coder. Stateless."""

    def __init__(self,
                 target_means: Sequence[float] = DEFAULT_MEANS,
                 target_stds: Sequence[float] = DEFAULT_STDS,
                 angle_range: str = 'v1',
                 angle_version: str = None):
        self.means: Tuple[float, ...] = tuple(target_means)
        self.stds: Tuple[float, ...] = tuple(target_stds)
        # `angle_range` is the reference's config key, `angle_version` the
        # JAX package's name for it
        self.angle_range = angle_version or angle_range

    def encode(self, bboxes, gt_bboxes):
        return _OBB_ENCODE[self.angle_range](bboxes, gt_bboxes, self.means,
                                             self.stds)

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        fn = _OBB_DECODE[self.angle_range]
        if self.angle_range == 'v1':
            return fn(bboxes, pred_bboxes, self.means, self.stds, max_shape,
                      wh_ratio_clip)
        return fn(bboxes, pred_bboxes, self.means, self.stds, wh_ratio_clip)


class DeltaXYWHAHBBoxCoder:
    """HBB(4, xyxy)-anchor -> OBB(5) coder (horizontal base anchors).
    Stateless; ``decode`` takes ``max_shape`` and ignores it, as the JAX
    package's does."""

    def __init__(self,
                 target_means: Sequence[float] = DEFAULT_MEANS,
                 target_stds: Sequence[float] = DEFAULT_STDS,
                 angle_range: str = 'v1',
                 angle_version: str = None):
        self.means: Tuple[float, ...] = tuple(target_means)
        self.stds: Tuple[float, ...] = tuple(target_stds)
        self.angle_range = angle_version or angle_range

    def encode(self, bboxes, gt_bboxes):
        return _HBB_ENCODE[self.angle_range](bboxes, gt_bboxes, self.means,
                                             self.stds)

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        return _HBB_DECODE[self.angle_range](bboxes, pred_bboxes, self.means,
                                             self.stds, wh_ratio_clip)
