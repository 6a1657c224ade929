"""The port's target construction against the JAX package's, on the CPU:
``max_iou_assign``, ``anchor_targets`` (both assignment branches) and the
RRandomSampler's deterministic core fed JAX's own uniform draws.

Inputs are numpy-seeded. Assignments, labels, weights and counts must be
identical; ``bbox_targets`` within 1e-5 (f32 encode arithmetic, the log of
the same ratios). JAX's ``anchor_targets`` runs op by op
(``jax.disable_jit``): compiled, XLA's CPU fusion contracts ``a * b + c``
into FMAs, which rounds IoUs that tie exactly (a gt inside several anchors
of one shape) a last bit apart and so breaks the ties of the low-quality
match otherwise.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.core import assigner as JA
from r3det_tpu.core import coders as JC
from r3det_tpu.core import samplers as JS
from r3det_tpu.core import targets as JT
from r3det_tpu.models.detectors import level_anchors as jax_level_anchors
from r3det_tpu.models.detectors import DetectorConfig as JCfg
from r3det_tpu_torch.core import assigner as TA
from r3det_tpu_torch.core import coders as TC
from r3det_tpu_torch.core import samplers as TS
from r3det_tpu_torch.core import targets as TT

torch.set_num_threads(2)
PI = math.pi
SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))      # a 64^2 image


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def iou_matrix(rng, b, g, a, kind):
    """(B, G, A) overlaps and (B, G) gt masks: 'random' (continuous),
    'ties' (values on a 0.1 grid, so maxima tie within rows and columns,
    thresholds hit exactly), 'padded' (a ragged number of real gts, one
    image with none), 'low' (every IoU below the negative threshold, so
    only the low-quality match assigns positives; one gt all zero)."""
    ov = rng.uniform(0, 1, (b, g, a)).astype(np.float32)
    mask = np.ones((b, g), bool)
    if kind == 'ties':
        ov = (np.round(ov * 10) / 10).astype(np.float32)
    elif kind == 'padded':
        for i in range(b):
            mask[i, rng.randint(0, g + 1) if i else 0:] = False
    elif kind == 'low':
        ov *= 0.35
        ov[:, 1] = 0.0
    return ov, mask


@pytest.mark.parametrize('kind', ['random', 'ties', 'padded', 'low'])
@pytest.mark.parametrize('low_quality', ['all', 'first', 'off'])
def test_max_iou_assign_matches_jax(kind, low_quality):
    """The low-quality match giving each gt every tying anchor ('all'),
    its first best anchor ('first'), or off."""
    rng = np.random.RandomState(len(kind))
    ov, mask = iou_matrix(rng, 3, 6, 50, kind)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
              match_low_quality=low_quality != 'off',
              gt_max_assign_all=low_quality == 'all')
    got = TA.max_iou_assign(t(ov), t(mask), **kw)
    assert got.assigned.dtype == torch.int32
    for i in range(ov.shape[0]):
        want = JA.max_iou_assign(jnp.asarray(ov[i]), jnp.asarray(mask[i]),
                                 **kw)
        np.testing.assert_array_equal(got.assigned[i].numpy(),
                                      np.asarray(want.assigned))
        np.testing.assert_array_equal(got.max_overlaps[i].numpy(),
                                      np.asarray(want.max_overlaps))


def test_max_iou_assign_empty_gt_and_highest_index_wins():
    # gt 0 and gt 1 both take anchor 0 as their best (0.3): the later wins
    ov = np.array([[[0.3, 0.1, 0.0], [0.3, 0.2, 0.0]]], np.float32)
    got = TA.max_iou_assign(t(ov), t(np.array([[True, True]])), 0.5, 0.4)
    assert got.assigned.tolist() == [[2, 0, 0]]
    # no real gt: every anchor is a negative
    got = TA.max_iou_assign(t(ov), t(np.array([[False, False]])), 0.5, 0.4)
    assert got.assigned.tolist() == [[0, 0, 0]]


def gts(rng, b, g, size, version):
    lo, hi = {'v1': (-PI / 2 + 0.05, -0.05), 'v3': (-PI / 2, PI / 2)}[version]
    boxes = np.stack([rng.uniform(6, size - 6, (b, g)),
                      rng.uniform(6, size - 6, (b, g)),
                      rng.uniform(8, 40, (b, g)), rng.uniform(6, 30, (b, g)),
                      rng.uniform(lo, hi, (b, g))], -1).astype(np.float32)
    labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        mask[i, :rng.randint(1, g + 1)] = True
    return boxes, labels, mask


def rois_near(rng, anchors, b, version):
    """Per-image rois: the anchors moved, resized and turned (the refine
    stages' boxes)."""
    lo, hi = {'v1': (-PI / 2 + 0.05, -0.05), 'v3': (-PI / 2, PI / 2)}[version]
    a = np.broadcast_to(anchors, (b,) + anchors.shape).copy()
    a[..., :2] += rng.uniform(-6, 6, a[..., :2].shape)
    a[..., 2:4] *= rng.uniform(0.6, 1.4, a[..., 2:4].shape)
    a[..., 4] = rng.uniform(lo, hi, a.shape[:-1])
    return a.astype(np.float32)


# The rotated cases run on per-image rois, as the refine stages do. On the
# shared grid anchors (theta 0) a small gt lies inside several anchors of
# one shape, whose IoUs then tie exactly in exact arithmetic; XLA's and
# torch's cos and sin round the rotated IoU a last bit apart, which breaks
# such ties one way or the other, so the low-quality match is not defined
# to the bit there.
CASES = {
    # R3Det's base head: circumscribed-hbb assignment, shared anchors
    'circum_v1': ('v1', 'v1', False),
    # the refine stages: rotated assignment on per-image rois
    'rotated_v1_rois': ('v1', None, True),
    # the same in v3 (the negated angle convention of the IoU)
    'rotated_v3_rois': ('v3', None, True),
}


@pytest.mark.parametrize('case', list(CASES))
def test_anchor_targets_match_jax(case):
    version, circum, per_image = CASES[case]
    rng = np.random.RandomState(7)
    anchors = np.concatenate(
        jax_level_anchors(JCfg(angle_version=version), SIZES), 0)
    anchors = np.asarray(anchors, np.float32)
    boxes, labels, mask = gts(rng, 2, 6, 64, version)
    if per_image:
        anchors = rois_near(rng, anchors, 2, version)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
              assign_by_circumhbbox=circum, angle_version=version)
    with jax.disable_jit():
        want = JT.anchor_targets(
            jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
            jnp.asarray(mask), JC.DeltaXYWHAOBBoxCoder(angle_version=version)
            .encode, 3, JT.TargetConfig(**kw), per_image_anchors=per_image)
    got = TT.anchor_targets(
        t(anchors), t(boxes), t(labels), t(mask),
        TC.DeltaXYWHAOBBoxCoder(angle_version=version).encode, 3,
        TT.TargetConfig(**kw), per_image_anchors=per_image)
    assert int(got.num_pos.sum()) > 0
    for name in ('labels', 'label_weights', 'bbox_weights', 'num_pos',
                 'assigned_gt', 'num_neg'):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        TT.num_total_samples(got.num_pos).numpy(),
        np.asarray(JT.num_total_samples(want.num_pos)))


@pytest.mark.parametrize('num,pos_fraction,neg_pos_ub', [
    (64, 0.5, -1.0), (16, 0.25, -1.0), (64, 0.5, 2.0), (400, 0.5, -1.0)])
def test_random_sample_core_matches_jax_on_its_draws(num, pos_fraction,
                                                     neg_pos_ub):
    rng = np.random.RandomState(num)
    assigned = rng.choice([-1, 0, 0, 0, 1, 2, 3], 500).astype(np.int32)
    key = jax.random.PRNGKey(num)
    want = JS.random_sample(key, jnp.asarray(assigned), num=num,
                            pos_fraction=pos_fraction,
                            neg_pos_ub=neg_pos_ub)
    r1, r2 = jax.random.split(key)
    u_pos = np.asarray(jax.random.uniform(r1, assigned.shape))
    u_neg = np.asarray(jax.random.uniform(r2, assigned.shape))
    got = TS.random_sample_masks(t(assigned), t(u_pos), t(u_neg), num=num,
                                 pos_fraction=pos_fraction,
                                 neg_pos_ub=neg_pos_ub)
    np.testing.assert_array_equal(got.pos_mask.numpy(),
                                  np.asarray(want.pos_mask))
    np.testing.assert_array_equal(got.neg_mask.numpy(),
                                  np.asarray(want.neg_mask))
    # batched: one row per image
    both = TS.random_sample_masks(t(np.stack([assigned] * 2)),
                                  t(np.stack([u_pos] * 2)),
                                  t(np.stack([u_neg] * 2)), num=num,
                                  pos_fraction=pos_fraction,
                                  neg_pos_ub=neg_pos_ub)
    assert torch.equal(both.pos_mask[1], got.pos_mask)
    assert torch.equal(both.neg_mask[0], got.neg_mask)


def test_sampler_route_draws_from_the_generator():
    """anchor_targets with a sampler: the budget holds, and the same
    generator seed gives the same masks."""
    rng = np.random.RandomState(3)
    anchors = np.asarray(np.concatenate(jax_level_anchors(JCfg(), SIZES), 0),
                         np.float32)
    boxes, labels, mask = gts(rng, 2, 6, 64, 'v1')
    cfg = TT.TargetConfig(sampler=TS.SamplerCfg(num=32, pos_fraction=0.25))
    enc = TC.DeltaXYWHAOBBoxCoder().encode
    args = (t(anchors), t(boxes), t(labels), t(mask), enc, 3, cfg)
    with pytest.raises(ValueError):
        TT.anchor_targets(*args)
    a = TT.anchor_targets(*args, generator=torch.Generator().manual_seed(5))
    b = TT.anchor_targets(*args, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.label_weights, b.label_weights)
    assert (a.num_pos <= 8).all() and ((a.num_pos + a.num_neg) <= 32).all()
