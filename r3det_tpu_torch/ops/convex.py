"""convex_sort: the order of masked candidate points around their centroid.

Port of ``r3det_tpu/ops/convex.py`` (the reference's ``convex_sort``
extension): the valid points of a convex-polygon boundary are ordered by
angle around their masked centroid; masked slots go last as -1. Plain
torch ops on any device.
"""
import torch


def convex_sort(pts, masks, circular=True):
    """pts (..., K, 2), masks (..., K) bool -> indices (..., K + 1) when
    ``circular`` (the first index repeated to close the ring) else
    (..., K); invalid slots are -1. Equal angles keep ascending index
    order (a stable sort, as ``jnp.argsort``)."""
    x, y = pts[..., 0], pts[..., 1]
    mf = masks.to(x.dtype)
    denom = mf.sum(-1, keepdim=True).clamp_min(1.0)
    cx = (x * mf).sum(-1, keepdim=True) / denom
    cy = (y * mf).sum(-1, keepdim=True) / denom
    ang = torch.atan2(y - cy, x - cx)
    ang = torch.where(masks, ang, torch.full_like(ang, float('inf')))
    order = torch.sort(ang, dim=-1, stable=True).indices
    idx = torch.where(masks.gather(-1, order), order,
                      torch.full_like(order, -1))
    if circular:
        return torch.cat([idx, idx[..., :1]], -1)
    return idx
