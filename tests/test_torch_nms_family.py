"""The port's NMS family against the JAX package's, on the CPU: ``rnms``
(both angle conventions), ``batched_rnms``, ``ml_nms_rotated``,
``obb_batched_nms``, ``poly_nms``, the unbatched ``multiclass_nms_rotated``
(v1/v2/v3/mmcv), the streamed sweep for budgets above
``STREAM_THRESHOLD`` (``greedy_keep_streamed`` against JAX's
``_greedy_keep_streamed`` and the port's dense sweep), and the batched
multiclass NMS with a budget above the threshold.

Inputs are numpy-seeded scenes of clustered boxes (so suppression
happens), tiny boxes (the v3 skip), several labels and bf16-rounded scores
(so exact ties happen). Keep sets and counts exactly; dets within 1e-6
(they are gathered input rows).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.ops import nms as J
from r3det_tpu.ops.rotated_iou import obb_corners
from r3det_tpu_torch.ops import nms as T

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def scene(rng, n, c=4, tiny=0.05):
    """(boxes (n, 5), scores (n,), labels (n,)): clusters of four around
    shared centres, a share ``tiny`` of boxes with a side of 5e-4."""
    centres = rng.uniform(0, 300, (n // 4 + 1, 2)).repeat(4, 0)[:n]
    boxes = np.concatenate([centres + rng.uniform(-6, 6, (n, 2)),
                            rng.uniform(10, 40, (n, 2)),
                            rng.uniform(-math.pi / 2, math.pi / 2, (n, 1))],
                           -1)
    small = rng.uniform(size=n) < tiny
    boxes[small, 2 + rng.randint(0, 2, small.sum())] = 5e-4
    scores = rng.uniform(0.05, 1.0, n)
    scores = np.asarray(jnp.asarray(scores).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    return (boxes.astype(np.float32), scores.astype(np.float32),
            rng.randint(0, c, n).astype(np.int32))


def same_keep(got, want):
    """(keep_idx, n) exactly."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])


def same_dets(got, want):
    """((dets, labels), n): labels and count exactly, dets within 1e-6."""
    (gd, gl), gn = got
    (wd, wl), wn = want
    assert int(gn) == int(wn) and int(gn) > 0
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


@pytest.mark.parametrize('negate', [False, True])
def test_rnms_matches_jax(negate):
    rng = np.random.RandomState(1)
    boxes, scores, _ = scene(rng, 300)
    dets = np.concatenate([boxes, scores[:, None]], -1)
    want = J.rnms(jnp.asarray(dets), 0.3, max_out=100, negate_angle=negate)
    got = T.rnms(t(dets), 0.3, max_out=100, negate_angle=negate)
    same_keep(got, want)
    assert int(got[1]) > 100          # the count is not clamped
    assert (got[0] >= 0).all()


@pytest.mark.parametrize('name', ['batched_rnms', 'ml_nms_rotated',
                                  'obb_batched_nms'])
def test_multilabel_nms_matches_jax(name):
    rng = np.random.RandomState(2)
    boxes, scores, labels = scene(rng, 600)
    args = (0.1,)
    want = getattr(J, name)(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(labels), *args, max_out=500)
    got = getattr(T, name)(t(boxes), t(scores), t(labels), *args,
                           max_out=500)
    same_dets(got, want)
    (_, gl), gn = got
    assert (gl[int(gn):] == -1).all()       # padded rows
    if name == 'obb_batched_nms':           # the tiny boxes are skipped
        kept = got[0][0][:int(gn)]
        assert (torch.minimum(kept[:, 2], kept[:, 3]) >= 1e-3).all()


def test_poly_nms_matches_jax():
    rng = np.random.RandomState(3)
    boxes, scores, _ = scene(rng, 200, tiny=0.0)
    polys = np.asarray(obb_corners(jnp.asarray(boxes))).reshape(-1, 8)
    scored = np.concatenate([polys, scores[:, None]], -1).astype(np.float32)
    want = J.poly_nms(jnp.asarray(scored), 0.2, max_out=250)
    got = T.poly_nms(t(scored), 0.2, max_out=250)
    same_keep(got, want)
    assert tuple(got[0].shape) == (200,) and 0 < int(got[1]) < 200


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3', 'mmcv'])
def test_multiclass_nms_rotated_matches_jax(version):
    """Unbatched: per-class boxes (N, C, 5), a budget that cuts the live
    pairs, and the tiny-box skip of v3."""
    rng = np.random.RandomState(4)
    n, c = 150, 3
    boxes = np.stack([scene(rng, n)[0] for _ in range(c)], 1)
    scores = np.where(rng.uniform(size=(n, c)) < 0.6,
                      rng.uniform(0.05, 1.0, (n, c)), 0.01)
    scores = np.concatenate([scores, np.zeros((n, 1))], -1).astype(np.float32)
    args = dict(score_thr=0.05, iou_thr=0.1, version=version, max_num=100,
                pre_topk=220)
    want = J.multiclass_nms_rotated(jnp.asarray(boxes), jnp.asarray(scores),
                                    **args)
    got = T.multiclass_nms_rotated(t(boxes), t(scores), **args)
    assert int(got[2]) == int(want[2]) > 0
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    with pytest.raises(NotImplementedError):
        T.multiclass_nms_rotated(t(boxes), t(scores), approx_topk=True,
                                 **args)


def stream_case(k=2600):
    """tests/test_nms.py's streamed-sweep scene: a dead tail past 2000 and
    a hole in the valid prefix."""
    r = np.random.RandomState(44)
    boxes = np.stack([
        r.uniform(0, 800, k), r.uniform(0, 800, k),
        r.uniform(10, 80, k), r.uniform(8, 60, k),
        r.uniform(-np.pi / 2, 0, k)], -1).astype(np.float32)
    labels = r.randint(0, 4, k).astype(np.int32)
    valid = np.ones(k, bool)
    valid[2000:] = False
    valid[150] = False
    return boxes, valid, labels, 2001


def test_streamed_sweep_matches_jax():
    boxes, valid, labels, vcount = stream_case()
    want = np.asarray(J._greedy_keep_streamed(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(labels), 0.2,
        jnp.int32(vcount), label_aware=True))
    got = T.greedy_keep_streamed(t(boxes)[None], t(valid)[None],
                                 t(labels)[None], 0.2, torch.tensor([vcount]))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 100 < int(got.sum()) < 2000


def test_streamed_sweep_equals_dense_batched():
    """Three images with their own valid counts (one a hole-punched prefix,
    one with no valid candidate), a K that is no multiple of the block."""
    boxes, valid, labels, _ = stream_case(k=600)
    valid[400:] = False
    b3 = torch.stack([t(boxes), t(boxes).flip(0), t(boxes)])
    v3 = torch.stack([t(valid), t(valid | True), t(valid & False)])
    l3 = torch.stack([t(labels)] * 3)
    args = (b3, v3, l3, 0.2, torch.tensor([401, 600, 0]))
    keep = T.greedy_keep_streamed(*args)
    assert torch.equal(keep, T.greedy_keep_dense(*args))
    assert keep[0].any() and keep[1].any() and not keep[2].any()


def test_batched_budget_above_threshold_matches_jax(monkeypatch):
    """multiclass_nms_rotated_batched with a budget above a lowered
    STREAM_THRESHOLD in both packages (a shape no other test traces, so no
    JAX trace of the dense branch is reused): the same detections, and the
    port's sweep streamed."""
    monkeypatch.setattr(J, 'STREAM_THRESHOLD', 256)
    monkeypatch.setattr(T, 'STREAM_THRESHOLD', 256)
    streamed = []
    real = T.greedy_keep_streamed

    def spy(*a, **kw):
        streamed.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(T, 'greedy_keep_streamed', spy)
    rng = np.random.RandomState(5)
    b, n, c = 2, 301, 3
    boxes = np.stack([scene(rng, n, tiny=0.05)[0] for _ in range(b)])
    scores = np.where(rng.uniform(size=(b, n, c)) < 0.8,
                      rng.uniform(0.05, 1.0, (b, n, c)), 0.01)
    scores = np.concatenate([scores, np.zeros((b, n, 1))], -1)
    scores = scores.astype(np.float32)
    # v3: the tiny-box skip and the negated angle
    args = dict(score_thr=0.05, iou_thr=0.1, version='v3', max_num=300,
                pre_topk=700)
    want = J.multiclass_nms_rotated_batched(
        jnp.asarray(boxes), jnp.asarray(scores), **args)
    got = T.multiclass_nms_rotated_batched(t(boxes), t(scores), **args)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    assert (got[2] > 0).all()
    assert streamed == [(b, 700, 5)]


def test_single_image_empty_input():
    keep, n = T.rnms(torch.zeros((0, 6)), 0.1)
    assert tuple(keep.shape) == (0,) and int(n) == 0
