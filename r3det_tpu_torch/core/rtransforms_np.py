"""Host-side (numpy) rotated-box conversions, without OpenCV.

Port of ``r3det_tpu/core/rtransforms_np.py``: the data pipeline's and the
evaluator's numpy conversions. ``poly2obb_np`` v1 and v3 need the minimum-
area rectangle of a quad; the JAX package takes it from
``cv2.minAreaRect``, the port from :func:`min_area_rect`, a C++ host helper
(``csrc/host_ops.cpp``) that returns what OpenCV 5.0 returns: centre and
size in float32, the angle in degrees in [-90, 0), an axis-aligned
rectangle at -90 with its sides swapped. The v1 / v3 folds below then run
in Python floats, as the JAX package's do on cv2's tuple.

Degenerate (sub-2 px) boxes give ``None``: the dataset drops them.
"""
import math

import numpy as np

from .. import _host

PI = math.pi


def norm_angle_np(angle, version):
    if version == 'v1':
        return angle
    elif version == 'v2':
        return (angle + PI / 4) % PI - PI / 4
    elif version == 'v3':
        return (angle + PI / 2) % PI - PI / 2
    raise ValueError(f'unknown angle version {version!r}')


def min_area_rect(quads):
    """(N, 4, 2) quads -> (N, 5) float32 ``(cx, cy, w, h, angle_deg)``,
    ``cv2.minAreaRect`` of each quad's four points."""
    pts = np.ascontiguousarray(quads, dtype=np.float32).reshape(-1, 4, 2)
    out = np.empty((len(pts), 5), np.float32)
    if len(pts):
        _host.host_ops().min_area_rect(pts.ctypes.data, out.ctypes.data,
                                       len(pts))
    return out


def poly2obb_np(poly, version='v1'):
    """Single polygon (8,) -> (cx, cy, w, h, theta) tuple or None."""
    if version == 'v1':
        return poly2obb_np_v1(poly)
    elif version == 'v2':
        return poly2obb_np_v2(poly)
    elif version == 'v3':
        return poly2obb_np_v3(poly)
    raise ValueError(f'unknown angle version {version!r}')


def polys2obbs_np(polys, version='v1'):
    """(N, 8) polygons -> list of N ``poly2obb_np`` results, with one
    batched minimum-area-rectangle call for v1 / v3."""
    polys = np.asarray(polys, np.float32).reshape(-1, 8)
    if version == 'v2':
        return [poly2obb_np_v2(p) for p in polys]
    fold = {'v1': _fold_v1, 'v3': _fold_v3}.get(version)
    if fold is None:
        raise ValueError(f'unknown angle version {version!r}')
    return [fold(*map(float, r)) for r in min_area_rect(polys)]


def _fold_v1(x, y, w, h, a):
    """Min-area rect folded into theta in [-pi/2, 0) with w/h swaps."""
    if w < 2 or h < 2:
        return None
    while not 0 > a >= -90:
        if a >= 0:
            a -= 90
        else:
            a += 90
        w, h = h, w
    a = a / 180 * PI
    return x, y, w, h, a


def _fold_v3(x, y, w, h, a):
    """Min-area rect with w >= h and theta in [-pi/2, pi/2)."""
    if w < 2 or h < 2:
        return None
    a = -a / 180 * PI
    if w < h:
        w, h = h, w
        a += PI / 2
    while not PI / 2 > a >= -PI / 2:
        a = a - PI if a >= PI / 2 else a + PI
    return x, y, w, h, a


def poly2obb_np_v1(poly):
    return _fold_v1(*map(float, min_area_rect(poly)[0]))


def poly2obb_np_v2(poly):
    """Longest-edge angle directly from the quad vertices."""
    p = np.asarray(poly[:8], dtype=np.float32)
    e1 = math.hypot(p[0] - p[2], p[1] - p[3])
    e2 = math.hypot(p[2] - p[4], p[3] - p[5])
    if e1 < 2 or e2 < 2:
        return None
    w, h = max(e1, e2), min(e1, e2)
    if e1 > e2:
        angle = math.atan2(float(p[3] - p[1]), float(p[2] - p[0]))
    else:
        angle = math.atan2(float(p[7] - p[1]), float(p[6] - p[0]))
    angle = norm_angle_np(angle, 'v2')
    cx = float(p[0] + p[4]) / 2
    cy = float(p[1] + p[5]) / 2
    return cx, cy, w, h, angle


def poly2obb_np_v3(poly):
    return _fold_v3(*map(float, min_area_rect(poly)[0]))


def obb2poly_np(rbboxes, version='v1'):
    """(N, 6) scored boxes -> (N, 9) scored polygons, version-dispatched."""
    if version == 'v1':
        return obb2poly_np_v1(rbboxes)
    elif version == 'v2':
        return obb2poly_np_v2(rbboxes)
    elif version == 'v3':
        return obb2poly_np_v3(rbboxes)
    raise ValueError(f'unknown angle version {version!r}')


def obb2poly_np_v1(rb):
    rb = np.asarray(rb)
    cx, cy, w, h, a, score = (rb[:, i] for i in range(6))
    cosa, sina = np.cos(a), np.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    return np.stack([
        cx - wx - hx, cy - wy - hy,
        cx + wx - hx, cy + wy - hy,
        cx + wx + hx, cy + wy + hy,
        cx - wx + hx, cy - wy + hy,
        score,
    ], axis=-1)


def obb2poly_np_v2(rb):
    """Rotation-matrix corners + best-begin-point reorder."""
    rb = np.asarray(rb, dtype=np.float32)
    if rb.shape[0] == 0:
        return np.zeros((0, 9), dtype=np.float32)
    cx, cy, w, h, a, score = (rb[:, i] for i in range(6))
    cosa, sina = np.cos(a), np.sin(a)
    dx = np.stack([-w, w, w, -w], axis=-1) * 0.5
    dy = np.stack([-h, -h, h, h], axis=-1) * 0.5
    px = cosa[:, None] * dx - sina[:, None] * dy + cx[:, None]
    py = sina[:, None] * dx + cosa[:, None] * dy + cy[:, None]
    polys = np.stack([px, py], axis=-1).reshape(-1, 8)
    polys = np.concatenate([polys, score[:, None]], axis=-1)
    return get_best_begin_point(polys)


def obb2poly_np_v3(rb):
    """The reference's v3 corners (note the -w sin / -h cos signs)."""
    rb = np.asarray(rb)
    if rb.size == 0:
        return np.zeros((1, 9), dtype=np.float32)
    center, w, h, theta, score = np.split(rb, (2, 3, 4, 5), axis=-1)
    cosa, sina = np.cos(theta), np.sin(theta)
    v1 = np.concatenate([w / 2 * cosa, -w / 2 * sina], axis=-1)
    v2 = np.concatenate([-h / 2 * sina, -h / 2 * cosa], axis=-1)
    p1 = center + v1 + v2
    p2 = center + v1 - v2
    p3 = center - v1 - v2
    p4 = center - v1 + v2
    return np.concatenate([p1, p2, p3, p4, score], axis=-1)


def get_best_begin_point(polys):
    """Rotate each quad's vertex order to best match its axis-aligned bbox
    corner order (tl, tr, br, bl), vectorized over N."""
    polys = np.asarray(polys)
    if polys.shape[0] == 0:
        return polys.reshape(0, 9)
    pts = polys[:, :8].reshape(-1, 4, 2)          # (N, 4, 2)
    score = polys[:, 8:]
    xmin = pts[..., 0].min(axis=1)
    ymin = pts[..., 1].min(axis=1)
    xmax = pts[..., 0].max(axis=1)
    ymax = pts[..., 1].max(axis=1)
    dst = np.stack([
        np.stack([xmin, ymin], -1), np.stack([xmax, ymin], -1),
        np.stack([xmax, ymax], -1), np.stack([xmin, ymax], -1),
    ], axis=1)                                     # (N, 4, 2)
    # all 4 cyclic shifts: (N, 4 shifts, 4 verts, 2)
    shifts = np.stack([np.roll(pts, -k, axis=1) for k in range(4)], axis=1)
    cost = np.linalg.norm(shifts - dst[:, None], axis=-1).sum(axis=-1)
    best = cost.argmin(axis=1)
    out = shifts[np.arange(len(pts)), best].reshape(-1, 8)
    return np.concatenate([out, score], axis=-1)


def rbbox2result(bboxes, labels, num_classes):
    """Split (n, 6) scored dets + labels into a per-class list of arrays."""
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    if bboxes.shape[0] == 0:
        return [np.zeros((0, 6), dtype=np.float32) for _ in range(num_classes)]
    return [bboxes[labels == i, :] for i in range(num_classes)]


def rbbox2roi(bbox_list):
    """Batch-index rotated boxes: list of per-image (n_i, 5+) arrays ->
    (sum n_i, 6) [batch_idx, cx, cy, w, h, theta]."""
    rois = []
    for img_id, bboxes in enumerate(bbox_list):
        bboxes = np.asarray(bboxes)
        if bboxes.shape[0] > 0:
            idx = np.full((bboxes.shape[0], 1), img_id, bboxes.dtype)
            rois.append(np.concatenate([idx, bboxes[:, :5]], axis=-1))
    if not rois:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(rois, axis=0)
