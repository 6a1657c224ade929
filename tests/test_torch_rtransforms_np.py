"""The port's host box conversions (``r3det_tpu_torch.core.rtransforms_np``)
against the JAX package's, which take the minimum-area rectangle from
``cv2.minAreaRect`` (OpenCV 5.0) where the port has its own C++ helper.

``poly2obb_np`` v1 / v2 / v3 on 2400 quads made from a numpy seed:
jittered rotated rectangles, exact (float32) rotated rectangles, axis-
aligned rectangles at integer and .5 corners (every 7th a square), near-
vertical long sides at DOTA's 0.1 px label precision, float32 rectangles
1e-4 degrees off the axes, and sub-2 px boxes. Tolerances: x, y, w, h
within 1e-3 px and theta within 1e-5 rad, the same ``None`` set, hence the
same fold side (a wrong side is off by pi/2 or pi). The helper repeats
OpenCV 5.0's arithmetic, as its x86-64 build computes it: it is bit-equal
to ``cv2.minAreaRect`` on random quads, on float32 rotated rectangles, on
near-axis quads whose caliper choices tie, and on degenerate quads.

Where float32 leaves the fold ambiguous the port still lands on cv2's
side: a rectangle 1e-4 degrees off the axes has edges along and across
the axes whose rectangles tie in float32 area (one folds to theta ~ 0, the
other to -pi/2 in v1 or +-pi/2 in v3), and an exact square in v3 compares
two equal sides in ``w < h``; both classes are in the set and held to the
same tolerances.
``obb2poly_np``, ``get_best_begin_point``, ``rbbox2result`` and
``rbbox2roi``: exactly.
"""
import math

import cv2
import numpy as np
import pytest

from r3det_tpu.core import rtransforms_np as J
from r3det_tpu_torch.core import rtransforms_np as T
from r3det_tpu_torch.datasets import transforms as TT

N_PER_KIND = 400


def _quads(seed):
    """(kind, (4, 2) f32 quad) pairs, N_PER_KIND of each kind."""
    rng = np.random.RandomState(seed)
    out = []

    def rect(w_range, angle):
        r = ((rng.uniform(50, 900), rng.uniform(50, 900)),
             (rng.uniform(*w_range), rng.uniform(*w_range)), angle)
        return cv2.boxPoints(r).astype(np.float32)

    for _ in range(N_PER_KIND):
        q = rect((8, 200), rng.uniform(-180, 180))
        out.append(('jittered', q + rng.normal(0, 1, (4, 2)).astype(
            np.float32)))
    for _ in range(N_PER_KIND):
        out.append(('rotated', rect((8, 200), rng.uniform(-180, 180))))
    for i in range(N_PER_KIND):
        x0, y0 = rng.randint(0, 900, 2) + (0.5 if i % 2 else 0.0)
        w, h = rng.randint(2, 150, 2) + (0.5 if i % 4 >= 2 else 0.0)
        if i % 7 == 0:
            h = w                                          # squares
        q = np.float32([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                        [x0, y0 + h]])
        q = np.roll(q, rng.randint(4), 0)
        out.append(('axis', q[::-1].copy() if i % 3 == 0 else q))
    for i in range(N_PER_KIND):
        # a long side within 0.1-1 px of vertical, at 0.1 px precision
        x0, y0 = np.round(rng.uniform(50, 900, 2), 1)
        w, h = np.round(rng.uniform(4, 40), 1), np.round(rng.uniform(60, 200),
                                                         1)
        d = rng.choice([0.1, -0.1, 0.3, -0.5, 1.0]) * (i % 5 != 0)
        q = np.float32([[x0, y0], [x0 + d, y0 + h], [x0 + d + w, y0 + h],
                        [x0 + w, y0]])
        out.append(('vertical', np.roll(q, rng.randint(4), 0)))
    for _ in range(N_PER_KIND):
        out.append(('near_axis', rect((3, 200), 90 * rng.randint(-2, 3) +
                                      rng.choice([1e-4, -1e-4]))))
    for i in range(N_PER_KIND):
        small = rng.uniform(0.05, 1.95)
        r = ((rng.uniform(50, 900), rng.uniform(50, 900)),
             (small, rng.uniform(0, 40)) if i % 2 else
             (rng.uniform(0, 40), small), rng.uniform(-180, 180))
        out.append(('sub2px', cv2.boxPoints(r).astype(np.float32)))
    return out


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
def test_poly2obb_np_matches_jax(version):
    kinds = {}
    for kind, q in _quads(0):
        want = J.poly2obb_np(q.reshape(-1), version)
        got = T.poly2obb_np(q.reshape(-1), version)
        assert (want is None) == (got is None), (kind, q.tolist(), want, got)
        counts = kinds.setdefault(kind, [0, 0])
        counts[want is None] += 1
        if want is None:
            continue
        w, g = np.array(want), np.array(got)
        assert np.abs(w[:4] - g[:4]).max() <= 1e-3, (kind, q.tolist(), w, g)
        assert abs(w[4] - g[4]) <= 1e-5, (kind, q.tolist(), w, g)
    # every kind is exercised; the sub-2 px boxes all filtered
    assert all(kinds[k][0] > 0 for k in kinds if k != 'sub2px'), kinds
    assert kinds['sub2px'] == [0, N_PER_KIND], kinds


def test_axis_aligned_rectangle_folds_as_cv2():
    """cv2 5.0 gives ((5, 2.5), (5, 10), -90) for this rectangle; v1 keeps
    theta = -pi/2 with w = 5 (an angle of -0.0 would give theta 0, w 10)."""
    q = np.float32([0, 0, 10, 0, 10, 5, 0, 5])
    np.testing.assert_array_equal(T.min_area_rect(q)[0],
                                  np.float32([5, 2.5, 5, 10, -90]))
    assert T.poly2obb_np(q, 'v1') == J.poly2obb_np(q, 'v1') == (
        5.0, 2.5, 5.0, 10.0, -math.pi / 2)


def test_min_area_rect_is_cv2_bit_for_bit_on_random_quads():
    rng = np.random.RandomState(2)
    quads = rng.uniform(0, 1000, (3000, 4, 2)).astype(np.float32)
    quads[::3] = np.round(quads[::3])
    np.testing.assert_array_equal(T.min_area_rect(quads), _cv2_rects(quads))


def _cv2_rects(quads):
    return np.array([[r[0][0], r[0][1], r[1][0], r[1][1], r[2]]
                     for r in map(cv2.minAreaRect, quads)], np.float32)


def _rect_corners(cx, cy, w, h, theta):
    """(n, 4, 2) float32 corners of rectangles at angle ``theta`` (rad),
    computed in float64."""
    c, s = np.cos(theta), np.sin(theta)
    pts = [np.stack([cx + sw * w / 2 * c - sh * h / 2 * s,
                     cy + sw * w / 2 * s + sh * h / 2 * c], -1)
           for sw, sh in ((1, 1), (-1, 1), (-1, -1), (1, -1))]
    return np.stack(pts, 1).astype(np.float32)


def _near_axis_quads(kind, n=200):
    """n seeded quads of one near-axis kind: rectangles whose sides lie
    within a float ulp of the axes, where the calipers' choices tie."""
    rng = np.random.RandomState(['v1_theta', 'turn90', 'turn180',
                                 'off_axis', 'rotated'].index(kind))
    cx, cy = rng.uniform(10, 1000, n), rng.uniform(10, 1000, n)
    w, h = rng.uniform(2, 300, n), rng.uniform(2, 300, n)
    if kind == 'v1_theta':           # v1 boxes at theta = -pi/2
        scored = np.stack([cx, cy, w, h, np.full(n, -math.pi / 2),
                           np.zeros(n)], -1)
        return T.obb2poly_np(scored, 'v1')[:, :8].reshape(-1, 4, 2) \
            .astype(np.float32)
    if kind in ('turn90', 'turn180'):  # axis-aligned boxes turned
        x0, y0 = np.round(rng.uniform(0, 500, (2, n)), 1)
        q = np.stack([np.stack([x0, y0], -1), np.stack([x0 + w, y0], -1),
                      np.stack([x0 + w, y0 + h], -1),
                      np.stack([x0, y0 + h], -1)], 1)
        m = TT.get_rotation_matrix_2d((256.5, 300.25),
                                      90 if kind == 'turn90' else 180, 1)
        return TT.transform_points(q.reshape(-1, 2), m).reshape(-1, 4, 2) \
            .astype(np.float32)
    if kind == 'off_axis':           # 1e-4 degrees off the axes
        theta = np.deg2rad(90 * rng.randint(-2, 3, n) +
                           rng.choice([1e-4, -1e-4], n))
    else:                            # float32 rotated rectangles
        theta = rng.uniform(-math.pi, math.pi, n)
    return _rect_corners(cx, cy, w, h, theta)


@pytest.mark.parametrize('kind', ['v1_theta', 'turn90', 'turn180',
                                  'off_axis', 'rotated'])
def test_min_area_rect_is_cv2_bit_for_bit_on_near_axis_quads(kind):
    """200 quads a kind (1000 in all, with the reproducer that OpenCV 5.0's
    rotatingCalipers once resolved otherwise): the same rectangle, angle
    and (w, h) order as cv2.minAreaRect, bit for bit."""
    quads = _near_axis_quads(kind)
    if kind == 'v1_theta':
        quads = np.concatenate([quads, np.float32(
            [[[49.70504, 46.638332], [49.705036, 16.032505],
              [70.30088, 16.032505], [70.30088, 46.638332]]])])
    np.testing.assert_array_equal(T.min_area_rect(quads), _cv2_rects(quads))


def test_min_area_rect_is_cv2_bit_for_bit_on_degenerate_quads():
    """Hulls of one and two points (a point, segments along each axis and
    both diagonals, either way round) and zero-area triangles."""
    quads = np.float32([
        [[1, 1]] * 4, [[0, 0]] * 4,
        [[1, 1], [3, 1], [3, 1], [1, 1]], [[3, 1], [1, 1], [1, 1], [3, 1]],
        [[1, 1], [1, 4], [1, 4], [1, 1]], [[1, 4], [1, 1], [1, 1], [1, 4]],
        [[1, 1], [3, 4], [3, 4], [1, 1]], [[3, 4], [1, 1], [1, 1], [3, 4]],
        [[1, 4], [3, 1], [3, 1], [1, 4]], [[3, 1], [1, 4], [1, 4], [3, 1]],
        [[1, 1], [3, -4], [2, -1.5], [1, 1]],
        [[0, 0], [2, 2], [4, 4], [1, 1]]])
    np.testing.assert_array_equal(T.min_area_rect(quads), _cv2_rects(quads))


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
def test_polys2obbs_np_is_poly2obb_np(version):
    polys = np.stack([q.reshape(-1) for _, q in _quads(3)[::7]])
    assert T.polys2obbs_np(polys, version) == [
        T.poly2obb_np(p, version) for p in polys]


def _scored_boxes(rng, n):
    return np.stack([rng.uniform(0, 1000, n), rng.uniform(0, 1000, n),
                     rng.uniform(2, 200, n), rng.uniform(2, 200, n),
                     rng.uniform(-math.pi, math.pi, n), rng.uniform(0, 1, n)],
                    -1)


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_obb2poly_np_matches_jax(version, dtype):
    rb = _scored_boxes(np.random.RandomState(4), 300).astype(dtype)
    np.testing.assert_array_equal(T.obb2poly_np(rb, version),
                                  J.obb2poly_np(rb, version))
    np.testing.assert_array_equal(T.obb2poly_np(rb[:0], version),
                                  J.obb2poly_np(rb[:0], version))


def test_get_best_begin_point_rbbox2result_rbbox2roi_match_jax():
    rng = np.random.RandomState(5)
    polys = np.concatenate([rng.uniform(0, 100, (200, 8)),
                            rng.uniform(0, 1, (200, 1))], -1)
    np.testing.assert_array_equal(T.get_best_begin_point(polys),
                                  J.get_best_begin_point(polys))
    dets = _scored_boxes(rng, 50).astype(np.float32)
    labels = rng.randint(0, 4, 50)
    for got, want in zip(T.rbbox2result(dets, labels, 4),
                         J.rbbox2result(dets, labels, 4)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(T.rbbox2result(dets[:0], labels[:0], 4),
                         J.rbbox2result(dets[:0], labels[:0], 4)):
        np.testing.assert_array_equal(got, want)
    bl = [dets[:10], dets[:0], dets[10:25]]
    np.testing.assert_array_equal(T.rbbox2roi(bl), J.rbbox2roi(bl))
    np.testing.assert_array_equal(T.rbbox2roi([]), J.rbbox2roi([]))
    for v in ('v1', 'v2', 'v3'):
        a = rng.uniform(-10, 10, 20)
        np.testing.assert_array_equal(T.norm_angle_np(a, v),
                                      J.norm_angle_np(a, v))
