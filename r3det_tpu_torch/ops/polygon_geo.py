"""Host polygon geometry: the shared C++ float64 engine through ctypes.

Port of ``r3det_tpu/ops/polygon_geo.py``: ``polygon_iou`` (DOTA's mAP
matching) and a greedy ``polygon_nms`` (the cross-patch merge), computed
by the repository's ``csrc/polygon_iou.cpp``, which the JAX package loads
too. The port builds its own copy into ``r3det_tpu_torch/build/`` with the
same flags (``_host.polygeo``); a failed build raises. ``_polygon_iou_np``
is the plain numpy form the tests hold the engine to.
"""
import ctypes

import numpy as np

from .. import _host

_DP = ctypes.POINTER(ctypes.c_double)


def _as_f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data_as(_DP)


def polygon_iou(polys1, polys2):
    """(N, 8) x (M, 8) -> (N, M) float64 IoU matrix (convex quads)."""
    p1 = _as_f64(polys1).reshape(-1, 8)
    p2 = _as_f64(polys2).reshape(-1, 8)
    n1, n2 = len(p1), len(p2)
    if n1 == 0 or n2 == 0:
        return np.zeros((n1, n2))
    out = np.empty((n1, n2), np.float64)
    _host.polygeo().polygon_iou_matrix(_ptr(p1), n1, _ptr(p2), n2, _ptr(out))
    return out


def polygon_nms(polys_scored, iou_thr):
    """Greedy NMS on (N, 9) scored quads -> kept indices (score order)."""
    p = _as_f64(polys_scored)
    n = len(p)
    if n == 0:
        return np.zeros((0,), np.int64)
    polys = np.ascontiguousarray(p[:, :8])
    scores = np.ascontiguousarray(p[:, 8])
    keep = np.empty((n,), np.int64)
    num = _host.polygeo().polygon_greedy_nms(
        _ptr(polys), _ptr(scores), n, float(iou_thr),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:num]


# ------------------------------ plain form -------------------------------

def _clip_poly(poly, a, b):
    out = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        c1 = ((b[0] - a[0]) * (cur[1] - a[1]) -
              (b[1] - a[1]) * (cur[0] - a[0]))
        c2 = ((b[0] - a[0]) * (nxt[1] - a[1]) -
              (b[1] - a[1]) * (nxt[0] - a[0]))
        if c1 >= 0:
            out.append(cur)
        if (c1 >= 0) != (c2 >= 0):
            t = c1 / (c1 - c2)
            out.append(cur + t * (nxt - cur))
    return out


def _shoelace(p):
    p = np.asarray(p)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def _ccw(q):
    q = q.reshape(4, 2)
    return q if _shoelace(q) >= 0 else q[::-1]


def _polygon_iou_np(p1, p2):
    """Sutherland-Hodgman clip + shoelace area, in numpy."""
    p1 = _as_f64(p1).reshape(-1, 8)
    p2 = _as_f64(p2).reshape(-1, 8)
    out = np.zeros((len(p1), len(p2)))
    quads1 = [_ccw(q) for q in p1]
    quads2 = [_ccw(q) for q in p2]
    a1 = [abs(_shoelace(q)) for q in quads1]
    a2 = [abs(_shoelace(q)) for q in quads2]
    for i, qa in enumerate(quads1):
        for j, qb in enumerate(quads2):
            poly = list(qa)
            for e in range(4):
                if len(poly) < 3:
                    break
                poly = _clip_poly(np.asarray(poly), qb[e], qb[(e + 1) % 4])
            inter = abs(_shoelace(np.asarray(poly))) if len(poly) >= 3 else 0.0
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 1e-12 else 0.0
    return out
