"""Parity of the port's kernel-backed ops (r3det_tpu_torch.ops) with the JAX
package, on the CPU: the plain PyTorch version of each kernel against the
JAX function and against the Pallas kernel in interpret mode, on the same
numpy inputs. tests/test_torch_kernels_gpu.py holds each CUDA kernel to
its plain version on a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models.frm import bilinear_sample as j_bilinear_sample
from r3det_tpu.models.frm import feature_refine_sample as j_frs
from r3det_tpu.ops import nms as j_nms
from r3det_tpu.ops.frm_sample import bilinear_sample_band
from r3det_tpu.ops.pallas_iou import rotated_iou_pallas
from r3det_tpu.ops.rotated_iou import negate_theta as j_negate_theta
from r3det_tpu.ops.rotated_iou import rotated_iou_pairwise as j_iou
from r3det_tpu.ops.stem_pool import (stem_conv_pool_reference as j_stem,
                                     stem_conv_pool_s2d4_pallas)
from r3det_tpu_torch import _ext
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.ops import nms
from r3det_tpu_torch.ops import rotated_iou as K1
from r3det_tpu_torch.ops import stem_pool as K3
from program_spans import sweep_branch, traced
# JAX-free scene generators
from test_torch_kernels_gpu import corner_pairs, frm_levels, misaligned

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def rand_boxes(rng, n, scale=200.0):
    """Rotated boxes with identical, touching and parallel-edge pairs."""
    b = np.stack([rng.uniform(0, scale, n), rng.uniform(0, scale, n),
                  rng.uniform(5, 60, n), rng.uniform(5, 60, n),
                  rng.uniform(-math.pi, math.pi, n)], -1)
    b[1] = b[0]                                        # identical
    b[3] = b[2]
    b[3, 0] += b[2, 2] * math.cos(b[2, 4])             # touching
    b[3, 1] += b[2, 2] * math.sin(b[2, 4])
    b[5] = b[4]
    b[5, 0] += 0.5 * b[4, 2] * math.cos(b[4, 4])       # parallel edges
    b[5, 1] += 0.5 * b[4, 2] * math.sin(b[4, 4])
    b[7] = b[6]
    b[7, 4] += math.pi / 2                             # square-on rotation
    return b.astype(np.float32)


# ---------------------------------------------------------------------------
# K1: rotated IoU (atol 1e-5: same f32 formula)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def iou_boxes():
    rng = np.random.RandomState(0)
    return rand_boxes(rng, 70), rand_boxes(rng, 90), rand_boxes(rng, 260)


# 70 boxes: 8-row pair tiles; 260: the 64-row tiles of NMS-sized problems
@pytest.mark.parametrize('n,vcount', [(70, 70), (70, 37), (70, 0),
                                      (260, 200)])
def test_rotated_iou_matches_pallas_interpret(iou_boxes, n, vcount):
    b = {70: iou_boxes[0], 260: iou_boxes[2]}[n]
    want = np.asarray(rotated_iou_pallas(
        jnp.asarray(b), jnp.asarray(b), interpret=True, upper_only=True,
        valid_count=vcount))
    got = K1.rotated_iou_reference(
        t(b)[None], t(b)[None], upper_only=True,
        valid_count=torch.tensor([vcount], dtype=torch.int32))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ((got == 0) == (want == 0)).all()


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_rotated_iou_matches_jnp(iou_boxes, mode):
    b1, b2 = iou_boxes[:2]
    want = np.asarray(j_iou(jnp.asarray(b1), jnp.asarray(b2), mode=mode,
                            backend='jnp'))
    got = K1.rotated_iou_pairwise(t(b1), t(b2), mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the batched wrapper on CPU tensors is the plain form
    batched = K1.rotated_iou(t(b1)[None].repeat(2, 1, 1),
                             t(b2)[None].repeat(2, 1, 1), mode=mode)
    np.testing.assert_array_equal(batched[1].numpy(), got)


def test_rotated_iou_self_and_negate_theta(iou_boxes):
    b = iou_boxes[0]
    got = K1.rotated_iou_pairwise(t(b), t(b)).numpy()
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    np.testing.assert_array_equal(K1.negate_theta(t(b)).numpy(),
                                  np.asarray(j_negate_theta(jnp.asarray(b))))


def test_rotated_iou_cuda_wrapper_rejects_cpu_tensors(iou_boxes):
    b = t(iou_boxes[0])[None]
    with pytest.raises(ValueError):
        K1.rotated_iou_cuda(b, b)


# K1's far-pair cull: wherever its predicate holds, the plain form and the
# Pallas kernel give exactly 0, so the kernel may store 0 without the
# integral

def cull_scene(scene):
    """(boxes1, boxes2) for the cull tests: rand_boxes scenes, dense, or
    corner-to-corner pairs just past and just inside the margin, as (P, 1,
    5) x (P, 1, 5) so that only the pairs themselves are computed."""
    if scene == 'corner_pairs':
        a, b = corner_pairs(np.random.RandomState(11), 3000)
        return t(a)[:, None], t(b)[:, None]
    x = t(rand_boxes(np.random.RandomState(int(scene[-1])), 300,
                     scale=600.0))
    return x, x


@pytest.mark.parametrize('mode', ['iou', 'iof'])
@pytest.mark.parametrize('scene', ['rand_0', 'rand_1', 'rand_2',
                                   'corner_pairs'])
def test_far_pairs_plain_iou_is_zero(scene, mode):
    b1, b2 = cull_scene(scene)
    far = K1.far_pairs(b1, b2)
    iou = K1.rotated_iou_pairwise(b1, b2, mode=mode)
    assert far.shape == iou.shape
    assert bool(far.any()) and bool((~far).any())
    assert bool((iou[far] == 0).all())


@pytest.mark.parametrize('scene', ['rand_0', 'corner_pairs'])
def test_far_pairs_jax_iou_is_zero(scene):
    """The JAX package's IoU on the pairs the cull removes, dense: its jnp
    form exactly 0 everywhere, its Pallas kernel (interpret mode) exactly 0
    but on boxes with parallel edges. Jit-compiled on the CPU the Pallas
    body rounds otherwise than op by op, and there it can leave a
    spurious span between disjoint boxes (e.g. two boxes at pi/4 whose
    centres are 328 apart, radii 69 and 83: IoU 0.048; the same formula
    evaluated eagerly gives 0)."""
    if scene == 'corner_pairs':
        a, b = corner_pairs(np.random.RandomState(12), 512)
    else:
        a = b = rand_boxes(np.random.RandomState(0), 300, scale=600.0)
    far = K1.far_pairs(t(a), t(b)).numpy()
    jn = np.asarray(j_iou(jnp.asarray(a), jnp.asarray(b), backend='jnp'))
    pallas = np.asarray(rotated_iou_pallas(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    assert far.any() and (jn[far] == 0).all()
    dt = np.mod(a[:, None, 4] - b[None, :, 4], np.float32(math.pi / 2))
    parallel = np.minimum(dt, math.pi / 2 - dt) < 1e-4
    assert (pallas[far & ~parallel] == 0).all()
    assert (far & (pallas != 0)).sum() <= 1e-4 * far.sum()
    if scene == 'corner_pairs':   # the pairs sit on both sides of the margin
        assert np.diag(far).any() and not np.diag(far).all()


@pytest.mark.parametrize('value', [math.nan, math.inf, -math.inf])
@pytest.mark.parametrize('field', range(5))
def test_far_pairs_never_culls_non_finite(field, value):
    x = np.zeros((6, 5), np.float32)
    x[:, 0] = np.arange(6) * 1000.0            # six boxes far apart
    x[:, 2:4] = 10.0
    x[2, field] = value
    far = K1.far_pairs(t(x), t(x)).numpy()
    assert not far[2].any() and not far[:, 2].any()
    rest = np.delete(np.arange(6), 2)
    assert (far[np.ix_(rest, rest)] == ~np.eye(5, dtype=bool)).all()


def test_far_pairs_share_on_candidate_scene():
    """Candidate-like boxes (uniform over 1024^2, sides 4-160): ~96% of
    pairs are culled."""
    rng = np.random.RandomState(0)
    k = 1500
    x = np.stack([rng.uniform(0, 1024, k), rng.uniform(0, 1024, k),
                  rng.uniform(4, 160, k), rng.uniform(4, 160, k),
                  rng.uniform(-math.pi / 2, math.pi / 2, k)],
                 -1).astype(np.float32)
    share = float(K1.far_pairs(t(x), t(x)).float().mean())
    assert 0.94 <= share <= 0.97


# ---------------------------------------------------------------------------
# K3: fused stem
# ---------------------------------------------------------------------------

def stem_inputs(rng, shape):
    return (rng.uniform(-2, 2, shape).astype(np.float32),
            rng.normal(0, 0.1, (4, 4, 12, 64)).astype(np.float32),
            rng.uniform(0.5, 2, 64).astype(np.float32),
            rng.uniform(-1, 1, 64).astype(np.float32))


def test_stem_plain_matches_reference_f32():
    x, k, s, b = stem_inputs(np.random.RandomState(5), (2, 32, 32, 12))
    want = np.asarray(j_stem(*map(jnp.asarray, (x, k, s, b)),
                             dtype=jnp.float32))
    got = K3.stem_conv_pool_reference(t(x), t(k), t(s), t(b),
                                      dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the wrapper on CPU tensors is the plain form
    np.testing.assert_array_equal(
        K3.stem_conv_pool(t(x), t(k), t(s), t(b), dtype=torch.float32).numpy(),
        got)


def test_stem_plain_matches_s2d4_pallas_bf16():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 64, 32, 12).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    k = (rng.randn(4, 4, 12, 64) * 0.1).astype(np.float32)
    s = (rng.rand(64) + 0.5).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(stem_conv_pool_s2d4_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k), jnp.asarray(s),
        jnp.asarray(b), interpret=True), np.float32)
    got = K3.stem_conv_pool_reference(t(x).to(torch.bfloat16), t(k), t(s),
                                      t(b)).float().numpy()
    assert got.shape == want.shape == (2, 32, 16, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_stem_cuda_wrapper_rejects_cpu_tensors():
    x, k, s, b = stem_inputs(np.random.RandomState(1), (1, 8, 8, 12))
    with pytest.raises(ValueError):
        K3.stem_conv_pool_cuda(t(x).to(torch.bfloat16),
                               K3.pack_stem(t(k), t(s), t(b)))


# ---------------------------------------------------------------------------
# K2: FRM sample (f32: same formula, atol 1e-5)
# ---------------------------------------------------------------------------

def grid_points(rng, b, h, w, spread, n_far=0):
    i = np.arange(h)[None, :, None]
    j = np.arange(w)[None, None, :]
    py = i + rng.uniform(-spread, spread, (b, h, w))
    px = j + rng.uniform(-spread, spread, (b, h, w))
    for _ in range(n_far):
        bb, ii, jj = rng.randint(b), rng.randint(h), rng.randint(w)
        py[bb, ii, jj] = rng.uniform(-2, h + 1)
        px[bb, ii, jj] = rng.uniform(-2, w + 1)
    return py.astype(np.float32), px.astype(np.float32)


@pytest.mark.parametrize('h,w', [(16, 16), (8, 8)])
def test_bilinear_sample_matches_gather_and_band(h, w):
    rng = np.random.RandomState(0)
    b, c = 2, 256
    feat = rng.randn(b, h, w, c).astype(np.float32)
    py, px = grid_points(rng, b, h, w, spread=1.5, n_far=12)
    got = K2.bilinear_sample(t(feat), t(py.reshape(b, -1)),
                             t(px.reshape(b, -1))).numpy().reshape(b, h, w, c)
    gather = np.asarray(j_bilinear_sample(
        jnp.asarray(feat), jnp.asarray(py.reshape(b, -1)),
        jnp.asarray(px.reshape(b, -1)))).reshape(b, h, w, c)
    band, n_out = bilinear_sample_band(
        jnp.asarray(feat), jnp.asarray(py), jnp.asarray(px),
        jnp.ones((b, h, w), bool), interpret=True)
    assert int(n_out) > 0           # the band kernel's correction ran
    np.testing.assert_allclose(got, gather, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(band), rtol=0, atol=1e-5)


@pytest.mark.parametrize('quirk', [True, False])
def test_frm_sample_matches_feature_refine_sample(quirk):
    rng = np.random.RandomState(3)
    b, h, w, c, stride = 2, 16, 16, 32, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    rois = np.stack([jj * stride + rng.uniform(-20, 20, (b, h, w)),
                     ii * stride + rng.uniform(-20, 20, (b, h, w)),
                     rng.uniform(8, 64, (b, h, w)),
                     rng.uniform(8, 64, (b, h, w)),
                     rng.uniform(-1.5, 1.5, (b, h, w))], -1)
    rois = rois.reshape(b, h * w, 5).astype(np.float32)
    want = x + np.asarray(j_frs(jnp.asarray(feat), jnp.asarray(rois),
                                1.0 / stride, 1, quirk))
    got = K2.frm_sample_levels_reference([t(x)], [t(feat)], [t(rois)],
                                         [1.0 / stride],
                                         transpose_quirk=quirk)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # points=5, the plain form only
    want5 = np.asarray(j_frs(jnp.asarray(feat), jnp.asarray(rois),
                             1.0 / stride, 5, quirk))
    got5 = K2.feature_refine_sample(t(feat), t(rois), 1.0 / stride, 5,
                                    quirk).numpy()
    np.testing.assert_allclose(got5, want5, rtol=0, atol=2e-5)


def test_frm_sample_cuda_wrapper_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        K2.frm_sample_levels_cuda([x], [x], [torch.zeros(1, 16, 5)],
                                  [0.125])


# five small levels: 16 x 16 .. 1 x 1 (strides 8 .. 128), 32 channels
FRM_SIZES = ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))


@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
def test_frm_sample_levels_reference_matches_jax(points, quirk):
    """The plain form of the levels op against the JAX package's
    feature_refine_sample, a level at a time, on rois near their cells,
    far off, on exact cell edges and on the (-1, H) bounds, with boxes
    larger than the map (f32: atol 1e-5, 2e-5 for the five-point sum)."""
    xs, feats, rois, scales = frm_levels(np.random.RandomState(points + quirk),
                                         2, FRM_SIZES, 32, 'cpu',
                                         torch.float32)
    got = K2.frm_sample_levels(xs, feats, rois, scales, points, quirk)
    assert len(got) == len(FRM_SIZES)
    for g, x, f, r, s in zip(got, xs, feats, rois, scales):
        want = x.numpy() + np.asarray(j_frs(jnp.asarray(f.numpy()),
                                            jnp.asarray(r.numpy()), s,
                                            points, quirk))
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 if points == 1 else 2e-5)


@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
def test_frm_sample_levels_backward_matches_jax_vjp(points, quirk):
    """K2's plain backward (autograd through the plain form,
    frm_sample_levels_bwd_reference, which the kernel's backward is held
    to on the card) against JAX's autodiff of feature_refine_sample, a
    level at a time (f32: atol 1e-5, 2e-5 for the five-point sum)."""
    rng = np.random.RandomState(10 + points + quirk)
    xs, feats, rois, scales = frm_levels(rng, 2, FRM_SIZES, 32, 'cpu',
                                         torch.float32)
    grads = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32))
             for f in feats]
    got = K2.frm_sample_levels_bwd_reference(grads, rois, scales, points,
                                             quirk)
    for d, g, f, r, s in zip(got, grads, feats, rois, scales):
        _, vjp = jax.vjp(lambda v: j_frs(v, jnp.asarray(r.numpy()), s,
                                         points, quirk),
                         jnp.asarray(f.numpy()))
        want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
        np.testing.assert_allclose(d.numpy(), want, rtol=0,
                                   atol=1e-5 if points == 1 else 2e-5)


def frm_wrapper_case(case):
    """(xs, feats, rois, scales, points) of one level on the CPU, made
    wrong in one way (``case``), for frm_sample_levels_cuda."""
    xs, feats, rois, scales = frm_levels(np.random.RandomState(5), 1,
                                         ((8, 8),), 16, 'cpu')
    points = 1
    if case == 'f32':
        xs, feats = [xs[0].float()], [feats[0].float()]
    elif case == 'channels':
        xs, feats = [xs[0][..., :12].contiguous()], \
            [feats[0][..., :12].contiguous()]
    elif case == 'misaligned':
        feats = [misaligned(feats[0])]
    elif case == 'rois':
        rois = [rois[0].double()]
    elif case == 'points':
        points = 3
    elif case == 'levels':
        xs, feats, rois, scales = (v * 9 for v in (xs, feats, rois, scales))
    return xs, feats, rois, scales, points


# each wrong input and the words of the ValueError it raises; 'cpu' is a
# right input on the CPU, which the kernel does not take
FRM_WRAPPER_CASES = {'cpu': 'CUDA', 'f32': 'bfloat16',
                     'channels': 'multiple of 8', 'misaligned': '16-byte',
                     'rois': 'rois', 'points': 'points', 'levels': 'levels'}


@pytest.mark.parametrize('case', list(FRM_WRAPPER_CASES))
def test_frm_sample_levels_cuda_wrapper_checks(case):
    with pytest.raises(ValueError, match=FRM_WRAPPER_CASES[case]):
        K2.frm_sample_levels_cuda(*frm_wrapper_case(case))


# ---------------------------------------------------------------------------
# NMS: identical keep sets on both branches of the adaptive budget
# ---------------------------------------------------------------------------

def nms_scene(rng, b, n, c, live_frac):
    """Clustered boxes (so suppression happens) and bf16-rounded scores
    (so exact ties happen); about ``live_frac`` of pairs above 0.05."""
    centers = rng.uniform(0, 300, (b, n // 4, 2)).repeat(4, 1)
    boxes = np.concatenate([
        centers + rng.uniform(-6, 6, (b, n, 2)),
        rng.uniform(10, 40, (b, n, 2)),
        rng.uniform(-math.pi / 2, math.pi / 2, (b, n, 1))], -1)
    scores = np.where(rng.uniform(size=(b, n, c)) < live_frac,
                      rng.uniform(0.05, 1.0, (b, n, c)),
                      rng.uniform(0, 0.05, (b, n, c)))
    scores = np.asarray(jnp.asarray(scores).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    scores = np.concatenate([scores, np.zeros((b, n, 1))], -1)
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
@pytest.mark.parametrize('branch,live_frac', [('small', 0.15),
                                              ('big', 0.9)])
def test_multiclass_nms_batched_matches_jax(version, branch, live_frac):
    rng = np.random.RandomState({'v1': 0, 'v2': 1, 'v3': 2}[version])
    boxes, scores = nms_scene(rng, 3, 96, 3, live_frac)
    args = dict(score_thr=0.05, iou_thr=0.1, version=version, max_num=40,
                pre_topk=200, small_k=80)
    want = j_nms.multiclass_nms_rotated_batched(
        jnp.asarray(boxes), jnp.asarray(scores), **args)
    (dets, labels, num), spans = traced(
        lambda: nms.multiclass_nms_rotated_batched(t(boxes), t(scores),
                                                   **args))
    assert sweep_branch(spans) == [branch], spans
    np.testing.assert_array_equal(num.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(dets.numpy(), np.asarray(want[0]))
    assert (num.numpy() > 0).all()


def test_greedy_keep_blocked_matches_sequential_greedy():
    rng = np.random.RandomState(4)
    b, k = 2, 300
    iou = rng.uniform(0, 0.3, (b, k, k)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.9
    keep = nms.greedy_keep_blocked(t(iou), t(valid), 0.2, block=64).numpy()
    for i in range(b):
        want = np.zeros(k, bool)
        for a in range(k):
            want[a] = valid[i, a] and not any(
                want[j] and iou[i, j, a] > 0.2 for j in range(a))
        np.testing.assert_array_equal(keep[i], want)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def test_ext_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(_ext, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_ext, '_lib', None)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _ext.lib()
    assert _ext._lib is None
