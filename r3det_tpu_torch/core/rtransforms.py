"""Rotated-box geometry for the three DOTA angle conventions.

Port of ``r3det_tpu/core/rtransforms.py`` (jnp) to torch, all three
versions:

- ``v1`` (R3Det):        theta in [-pi/2, 0); w/h swap on quadrant parity.
- ``v2`` (S2ANet):       theta in [-pi/4, 3pi/4); longest-edge angle.
- ``v3`` (OBBDetection): theta in [-pi/2, pi/2); w >= h enforced.

Boxes are ``(..., 5)`` tensors ``(cx, cy, w, h, theta)``; polygons
``(..., 8)`` tensors ``(x0, y0, x1, y1, x2, y2, x3, y3)``. The reference's
quirks are kept, above all ``obb2hbb_v1``'s w/h slot swap. ``%`` on
tensors is Python's floored modulo, as ``jnp``'s is.
"""
import math

import torch

PI = math.pi

VERSIONS = ('v1', 'v2', 'v3')


def norm_angle(angle, version):
    """Angles into the canonical range of ``version`` (v1: identity)."""
    if version == 'v1':
        return angle
    if version == 'v2':
        return (angle + PI / 4) % PI - PI / 4
    if version == 'v3':
        return (angle + PI / 2) % PI - PI / 2
    raise ValueError(f'unknown angle version {version!r}')


def _dispatch(table, version, x):
    try:
        fn = table[version]
    except KeyError:
        raise ValueError(f'unknown angle version {version!r}; expected one '
                         f'of {VERSIONS}') from None
    return fn(x)


def _unpack5(rb):
    return [rb[..., i] for i in range(5)]


# ---------------------------------------------------------------------------
# poly -> obb
# ---------------------------------------------------------------------------

def poly2obb(polys, version='v1'):
    """(..., 8) polygon -> (..., 5) oriented box."""
    return _dispatch({'v1': poly2obb_v1, 'v2': poly2obb_v2,
                      'v3': poly2obb_v3}, version, polys)


def poly2obb_v1(polys):
    """Angle of edge p0->p1 as atan2(-dx, dy), folded into (-pi/2, 0] with
    a w/h swap on odd quadrants."""
    pts = polys.reshape(polys.shape[:-1] + (4, 2))
    cx = pts[..., 0].mean(-1)
    cy = pts[..., 1].mean(-1)
    w_ = torch.linalg.norm(pts[..., 0, :] - pts[..., 1, :], dim=-1)
    h_ = torch.linalg.norm(pts[..., 1, :] - pts[..., 2, :], dim=-1)
    theta_ = torch.atan2(-(pts[..., 1, 0] - pts[..., 0, 0]),
                         pts[..., 1, 1] - pts[..., 0, 1])
    odd = torch.floor(theta_ / (-PI * 0.5)) % 2 == 0
    w = torch.where(odd, h_, w_)
    h = torch.where(odd, w_, h_)
    theta = torch.remainder(theta_, -PI * 0.5)
    return torch.stack([cx, cy, w, h, theta], dim=-1)


def _poly2obb_longest_edge(polys, version):
    """v2/v3: the angle of the longest rectangle edge."""
    p = polys.reshape(polys.shape[:-1] + (8,))
    x0, y0, x1, y1, x2, y2, x3, y3 = [p[..., i] for i in range(8)]
    edge1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    edge2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    angle1 = torch.atan2(y1 - y0, x1 - x0)
    angle2 = torch.atan2(y3 - y0, x3 - x0)
    angle = norm_angle(torch.where(edge1 > edge2, angle1, angle2), version)
    cx = (x0 + x2) / 2.0
    cy = (y0 + y2) / 2.0
    w = torch.maximum(edge1, edge2)
    h = torch.minimum(edge1, edge2)
    return torch.stack([cx, cy, w, h, angle], dim=-1)


def poly2obb_v2(polys):
    return _poly2obb_longest_edge(polys, 'v2')


def poly2obb_v3(polys):
    return _poly2obb_longest_edge(polys, 'v3')


# ---------------------------------------------------------------------------
# obb -> poly
# ---------------------------------------------------------------------------

def obb2poly(rbboxes, version='v1'):
    """(..., 5) oriented box -> (..., 8) polygon."""
    return _dispatch({'v1': obb2poly_v1, 'v2': obb2poly_v2,
                      'v3': obb2poly_v3}, version, rbboxes)


def obb2poly_v1(rb):
    """v1 corner order: w-axis (cos, sin), h-axis (-sin, cos)."""
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    return torch.stack([
        cx - wx - hx, cy - wy - hy,
        cx + wx - hx, cy + wy - hy,
        cx + wx + hx, cy + wy + hy,
        cx - wx + hx, cy - wy + hy,
    ], dim=-1)


def _obb2poly_rot(rb):
    """v2/v3: box-frame corners (tl, tr, br, bl) rotated by R(theta)."""
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    dx = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    dy = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    px = cosa[..., None] * dx - sina[..., None] * dy + cx[..., None]
    py = sina[..., None] * dx + cosa[..., None] * dy + cy[..., None]
    return torch.stack([px, py], dim=-1).reshape(rb.shape[:-1] + (8,))


obb2poly_v2 = _obb2poly_rot
obb2poly_v3 = _obb2poly_rot


# ---------------------------------------------------------------------------
# obb -> hbb (5-parameter horizontal box) and obb -> xyxy
# ---------------------------------------------------------------------------

def obb2hbb(rb, version='v1'):
    return _dispatch({'v1': obb2hbb_v1, 'v2': obb2hbb_v2,
                      'v3': obb2hbb_v3}, version, rb)


def obb2hbb_v1(rb):
    """The reference's quirk, kept: the height extent goes into the w slot
    and the width extent into the h slot, with theta = -pi/2."""
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    hw = cosa * w - sina * h
    hh = -sina * w + cosa * h
    return torch.stack([cx, cy, hh, hw, torch.full_like(a, -PI / 2)], dim=-1)


def obb2hbb_v2(rb):
    """Axis-aligned extent of the polygon; the long edge goes to w, theta =
    pi/2 when the tall side wins, else 0."""
    polys = obb2poly_v2(rb)
    xs, ys = polys[..., 0::2], polys[..., 1::2]
    xmin, xmax = xs.amin(-1), xs.amax(-1)
    ymin, ymax = ys.amin(-1), ys.amax(-1)
    cx = (xmin + xmax) / 2.0
    cy = (ymin + ymax) / 2.0
    e1 = (xmax - xmin).abs()
    e2 = (ymax - ymin).abs()
    tall = e1 < e2
    w = torch.where(tall, e2, e1)
    h = torch.where(tall, e1, e2)
    a = torch.where(tall, torch.full_like(w, PI / 2), torch.zeros_like(w))
    return torch.stack([cx, cy, w, h, a], dim=-1)


def obb2hbb_v3(rb):
    """Closed-form extent |w cos| + |h sin|, w >= h, theta in {0, -pi/2}."""
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    ex = (w / 2 * cosa).abs() + (h / 2 * sina).abs()
    ey = (w / 2 * sina).abs() + (h / 2 * cosa).abs()
    w2, h2 = 2 * ex, 2 * ey
    wide = w2 >= h2
    return torch.stack([
        cx, cy,
        torch.where(wide, w2, h2),
        torch.where(wide, h2, w2),
        torch.where(wide, torch.zeros_like(w2), torch.full_like(w2, -PI / 2)),
    ], dim=-1)


def obb2xyxy(rb, version='v1'):
    return _dispatch({'v1': obb2xyxy_v1, 'v2': obb2xyxy_v2,
                      'v3': obb2xyxy_v3}, version, rb)


def obb2xyxy_v1(rb):
    """For v1 angles cos(a) > 0 >= sin(a), so (cos*w - sin*h, -sin*w +
    cos*h) are the positive extents."""
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    hw = cosa * w - sina * h
    hh = -sina * w + cosa * h
    return torch.stack([cx - hw / 2, cy - hh / 2, cx + hw / 2, cy + hh / 2],
                       dim=-1)


def obb2xyxy_v2(rb):
    polys = obb2poly_v2(rb)
    xs, ys = polys[..., 0::2], polys[..., 1::2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)],
                       dim=-1)


def obb2xyxy_v3(rb):
    cx, cy, w, h, a = _unpack5(rb)
    cosa, sina = torch.cos(a), torch.sin(a)
    ex = (w / 2 * cosa).abs() + (h / 2 * sina).abs()
    ey = (w / 2 * sina).abs() + (h / 2 * cosa).abs()
    return torch.stack([cx - ex, cy - ey, cx + ex, cy + ey], dim=-1)


# ---------------------------------------------------------------------------
# hbb (xyxy) -> obb
# ---------------------------------------------------------------------------

def hbb2obb(hb, version='v1'):
    return _dispatch({'v1': hbb2obb_v1, 'v2': hbb2obb_v2,
                      'v3': hbb2obb_v3}, version, hb)


def hbb2obb_v1(hb):
    """(cx, cy, h, w, -pi/2)."""
    cx = (hb[..., 0] + hb[..., 2]) * 0.5
    cy = (hb[..., 1] + hb[..., 3]) * 0.5
    w = hb[..., 2] - hb[..., 0]
    h = hb[..., 3] - hb[..., 1]
    return torch.stack([cx, cy, h, w, torch.full_like(cx, -PI / 2)], dim=-1)


def _hbb2obb_regular(hb, tall_angle):
    cx = (hb[..., 0] + hb[..., 2]) * 0.5
    cy = (hb[..., 1] + hb[..., 3]) * 0.5
    w = hb[..., 2] - hb[..., 0]
    h = hb[..., 3] - hb[..., 1]
    wide = w >= h
    return torch.stack([
        cx, cy,
        torch.where(wide, w, h),
        torch.where(wide, h, w),
        torch.where(wide, torch.zeros_like(w), torch.full_like(w, tall_angle)),
    ], dim=-1)


def hbb2obb_v2(hb):
    """Tall boxes get theta = +pi/2."""
    return _hbb2obb_regular(hb, PI / 2)


def hbb2obb_v3(hb):
    """Tall boxes get theta = -pi/2."""
    return _hbb2obb_regular(hb, -PI / 2)
