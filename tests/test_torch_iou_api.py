"""The port's IoU API against the JAX package's, on the CPU:
``rbbox_overlaps`` (pairwise through the port's ``rotated_iou``, aligned,
iou / iof, a 6th score column, the negated angle, the small-box rule), the
three calculators of ``core/iou_calculators.py``, ``rotated_iou_aligned``,
``quad_iou_pairwise`` and ``ops/convex.py::convex_sort``.

Inputs are numpy-seeded scenes of clustered boxes (so overlaps happen)
with tiny boxes mixed in. Overlaps within 1e-5 absolute (the same f32
formula, summed in another order), except where the quotient is
ill-conditioned in f32: the IoU of two tiny boxes (crossing needles, one
side 5e-4 and the other tens of pixels, overlap in a sliver) and the IoF
of a tiny first box (the intersection over a needle's 0.03 px^2). There
JAX's own compiled and op-by-op forms lie up to 9.8e-5 (IoU) and 5.2e-3
(IoF) apart on these scenes, and such pairs are held within NEEDLE_ATOL.
``convex_sort``'s indices exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.core import iou_calculators as JI
from r3det_tpu.ops import rotated_iou as JR
from r3det_tpu.ops.convex import convex_sort as j_convex_sort
from r3det_tpu_torch.core import iou_calculators as TI
from r3det_tpu_torch.ops import rotated_iou as TR
from r3det_tpu_torch.ops.convex import convex_sort

torch.set_num_threads(2)
ATOL = 1e-5
NEEDLE_ATOL = 1e-2
N1, N2 = 200, 150          # pairwise scene sizes (one JAX trace per mode)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def scene(rng, n, score=False):
    """Boxes in clusters of four, 1 in 10 tiny (min side below 1e-3), with
    v1-to-v3 angles; a score column when ``score``."""
    centres = rng.uniform(0, 400, (n // 4 + 1, 2)).repeat(4, 0)[:n]
    b = np.concatenate([centres + rng.uniform(-8, 8, (n, 2)),
                        rng.uniform(6, 60, (n, 2)),
                        rng.uniform(-math.pi / 2, math.pi / 2, (n, 1))], -1)
    tiny = rng.uniform(size=n) < 0.1
    b[tiny, 2 + rng.randint(0, 2, tiny.sum())] = 5e-4
    if score:
        b = np.concatenate([b, rng.uniform(0, 1, (n, 1))], -1)
    return b.astype(np.float32)


@pytest.fixture(scope='module')
def scenes():
    rng = np.random.RandomState(0)
    return dict(a=scene(rng, N1, score=True), b=scene(rng, N2),
                aligned=scene(rng, 400), aligned2=scene(rng, 400, score=True))


def needle(boxes):
    return np.minimum(boxes[:, 2], boxes[:, 3]) < 1e-3


def close(got, want, a, b, mode='iou', aligned=False):
    """``got`` within ATOL of ``want`` (rows of ``a`` against columns of
    ``b``, or aligned); the ill-conditioned pairs within NEEDLE_ATOL: two
    tiny boxes, or under 'iof' a tiny first box."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    na, nb = needle(a), needle(b)
    if not aligned:
        na, nb = na[:, None], nb[None, :]
    err = np.abs(got.numpy() - want)
    ill = na & nb if mode == 'iou' else np.broadcast_to(na, err.shape)
    assert err[~ill].max() <= ATOL, err[~ill].max()
    assert err[ill].max(initial=0.0) <= NEEDLE_ATOL


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
@pytest.mark.parametrize('aligned', [False, True])
def test_calculators_match_jax(scenes, version, mode, aligned):
    """Each calculator, class and function form, on a 6-column first
    operand: v1 plain, v2 the negated angle, v3 also the small-box rule."""
    a, b = (scenes['aligned2'], scenes['aligned']) if aligned else \
        (scenes['a'], scenes['b'])
    want = getattr(JI, f'rbbox_overlaps_{version}')(
        jnp.asarray(a), jnp.asarray(b), mode, aligned)
    got = getattr(TI, f'rbbox_overlaps_{version}')(t(a), t(b), mode, aligned)
    close(got, want, a, b, mode, aligned)
    cls = getattr(TI, f'RBboxOverlaps2D_{version}')()
    assert torch.equal(cls(t(a), t(b), mode=mode, is_aligned=aligned), got)
    assert repr(cls) == f'RBboxOverlaps2D_{version}()'
    if version == 'v3':                 # the rule zeroes the tiny boxes
        tiny = np.minimum(a[:, 2], a[:, 3]) < 1e-3
        assert tiny.any() and not got[t(tiny)].any()


@pytest.mark.parametrize('negate,thr', [(False, None), (True, None),
                                        (False, 1e-3), (True, 10.0)])
def test_rbbox_overlaps_matches_jax(scenes, negate, thr):
    a, b = scenes['a'][:, :5], scenes['b']
    kw = dict(small_box_thr=thr, negate_angle=negate)
    close(TR.rbbox_overlaps(t(a), t(b), **kw),
          JR.rbbox_overlaps(jnp.asarray(a), jnp.asarray(b), **kw), a, b)
    # the plain route (what ``kernels`` off takes on a card) is the same
    # function on the CPU
    assert torch.equal(TR.rbbox_overlaps(t(a), t(b), **kw),
                       TR.rbbox_overlaps(t(a), t(b), kernels=False, **kw))


def test_rbbox_overlaps_empty_and_bad_mode():
    e = torch.zeros((0, 5))
    b = torch.ones((3, 5))
    assert tuple(TR.rbbox_overlaps(e, b).shape) == (0, 3)
    assert tuple(TR.rbbox_overlaps(b, e).shape) == (3, 0)
    assert tuple(TR.rbbox_overlaps(e, e, is_aligned=True).shape) == (0,)
    with pytest.raises(ValueError):
        TR.rbbox_overlaps(b, b, mode='giou')


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_rotated_iou_aligned_matches_jax(scenes, mode):
    a, b = scenes['aligned'], scenes['aligned2'][:, :5]
    want = JR.rotated_iou_aligned(jnp.asarray(a), jnp.asarray(b), mode=mode)
    got = TR.rotated_iou_aligned(t(a), t(b), mode=mode)
    close(got, want, a, b, mode, aligned=True)
    # the diagonal of the pairwise form
    pair = TR.rotated_iou_pairwise(t(a[:50]), t(b[:50]), mode)
    np.testing.assert_allclose(got[:50].numpy(), np.diagonal(pair.numpy()),
                               rtol=0, atol=ATOL)


def quads(boxes):
    return np.asarray(JR.obb_corners(jnp.asarray(boxes))).reshape(-1, 8)


def test_quad_iou_pairwise_matches_jax(scenes):
    q1, q2 = quads(scenes['a'][:, :5]), quads(scenes['b'])
    want = JR.quad_iou_pairwise(jnp.asarray(q1), jnp.asarray(q2))
    got = TR.quad_iou_pairwise(t(q1), t(q2))
    close(got, want, scenes['a'], scenes['b'])
    assert float(got.max()) > 0.3
    # the quads of two boxes overlap as the boxes do (not centred first,
    # the quad form loses the needles' precision)
    ok = ~(needle(scenes['a'])[:, None] | needle(scenes['b'])[None, :])
    rot = TR.rotated_iou_pairwise(t(scenes['a'][:, :5]), t(scenes['b']))
    np.testing.assert_allclose(got.numpy()[ok], rot.numpy()[ok], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('circular', [True, False])
def test_convex_sort_matches_jax(circular):
    """Polygon-boundary candidates (24 slots: the corners of two boxes and
    their edge crossings, jittered), random masks, duplicated points (equal
    angles: ascending index wins), an all-masked row and a single point."""
    rng = np.random.RandomState(1)
    b, k = 64, 24
    ang = rng.uniform(-math.pi, math.pi, (b, k))
    r = rng.uniform(5, 20, (b, k))
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1) + \
        rng.uniform(-100, 100, (b, 1, 2))
    pts[:, 5] = pts[:, 2]                              # duplicates
    pts[:, 17] = pts[:, 2]
    masks = rng.uniform(size=(b, k)) < 0.6
    masks[:, 2] = masks[:, 5] = masks[:, 17] = True
    masks[0] = False
    masks[1] = False
    masks[1, 7] = True
    pts = pts.astype(np.float32)
    want = np.asarray(j_convex_sort(jnp.asarray(pts), jnp.asarray(masks),
                                    circular=circular))
    got = convex_sort(t(pts), t(masks), circular=circular)
    assert tuple(got.shape) == (b, k + int(circular))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == -1).all() and got[1, 0] == 7
