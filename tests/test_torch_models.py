"""Parity of the port's modules (r3det_tpu_torch.models, core) with the JAX
package on the CPU, in float32: the same numpy inputs and the same weights
(flax variables through ``utils/convert.py::from_flax``) go through the
flax module and its port.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.core import coders as j_coders
from r3det_tpu.core.anchors import RAnchorGenerator as JAnchors
from r3det_tpu.models.fpn import FPN as JFPN
from r3det_tpu.models.frm import FeatureRefineModule as JFRM
from r3det_tpu.models.resnet import ResNet as JResNet
from r3det_tpu.models.retina_head import RRetinaHead as JHead
from r3det_tpu_torch.core import coders
from r3det_tpu_torch.core.anchors import RAnchorGenerator
from r3det_tpu_torch.models.fpn import FPN
from r3det_tpu_torch.models import frm as frm_module
from r3det_tpu_torch.models.frm import FeatureRefineModule
from r3det_tpu_torch.models.resnet import ResNet
from r3det_tpu_torch.models.retina_head import RRetinaHead
from r3det_tpu_torch.utils.convert import from_flax, seeded_state_dict

torch.set_num_threads(2)
RTOL = 1e-4     # f32 convs summed in another order, through depth


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def nchw(a):
    """NHWC numpy -> NCHW channels_last tensor (the port's activations)."""
    return t(a).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def perturb(variables, rng, scale=0.3):
    """Random FrozenBN statistics and affine, so the BN fold is exercised
    (flax init leaves them at the identity)."""
    def visit(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = visit(v, path + (k,))
            elif k in ('mean', 'bias') and 'bn' in ''.join(path + (k,)):
                out[k] = rng.normal(0, scale, v.shape).astype(np.float32)
            elif k in ('var', 'scale') and 'bn' in ''.join(path + (k,)):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return visit(variables)


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize('depth', [10, 14])
def test_resnet_matches_flax(depth):
    rng = np.random.RandomState(depth)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JResNet(depth=depth, dtype=jnp.float32)
    v = perturb(jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(img))), rng)
    want = jm.apply(v, jnp.asarray(img))
    tm = ResNet(depth=depth, dtype=torch.float32).eval()
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = tm(t(img))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert_close(nhwc(g), w)


@pytest.fixture(scope='module')
def pyramid():
    """C2..C5 inputs and P3..P7 FPN outputs of a 64x64 image."""
    rng = np.random.RandomState(1)
    c = [rng.randn(2, 16 // 2 ** i, 16 // 2 ** i, ch).astype(np.float32)
         for i, ch in enumerate((256, 512, 1024, 2048))]
    jm = JFPN(out_channels=32)
    v = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(1), [jnp.asarray(a) for a in c]))
    want = jm.apply(v, [jnp.asarray(a) for a in c])
    return c, v, [np.asarray(w) for w in want]


def test_fpn_matches_flax(pyramid):
    c, v, want = pyramid
    tm = FPN(out_channels=32).eval()
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = tm([nchw(a) for a in c])
    assert [g.shape[2] for g in got] == [8, 4, 2, 1, 1]
    for g, w in zip(got, want):
        assert_close(nhwc(g), w)


@pytest.mark.parametrize('anchors', [9, 1])
def test_retina_head_matches_flax(pyramid, anchors):
    feats = pyramid[2]
    jm = JHead(num_classes=3, feat_channels=32, stacked_convs=2,
               num_anchors=anchors)
    v = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats]))
    # larger prediction weights, so the outputs are not all bias
    v['params']['retina_cls']['kernel'] *= 50
    v['params']['retina_reg']['kernel'] *= 50
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    tm = RRetinaHead(num_classes=3, in_channels=32, feat_channels=32,
                     stacked_convs=2, num_anchors=anchors).eval()
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for g_lvls, w_lvls in zip(got, want):
        for g, w in zip(g_lvls, w_lvls):
            assert g.dtype == torch.float32
            assert tuple(g.shape) == w.shape
            assert_close(g.numpy(), w)


def test_retina_head_focal_bias():
    head = RRetinaHead(num_classes=3, in_channels=8, feat_channels=8,
                       stacked_convs=1)
    np.testing.assert_allclose(head.retina_cls.bias.detach().numpy(),
                               -math.log(99.0), rtol=1e-6)


@pytest.mark.parametrize('points', [1, 5])
def test_frm_module_matches_flax(pyramid, points):
    feats = pyramid[2]
    rng = np.random.RandomState(points)
    strides = (8, 16, 32, 64, 128)
    rois = []
    for f, s in zip(feats, strides):
        b, h, w, _ = f.shape
        jj, ii = np.meshgrid(np.arange(w), np.arange(h))
        rois.append(np.stack([
            jj * s + rng.uniform(-2 * s, 2 * s, (b, h, w)),
            ii * s + rng.uniform(-2 * s, 2 * s, (b, h, w)),
            rng.uniform(s, 4 * s, (b, h, w)), rng.uniform(s, 4 * s, (b, h, w)),
            rng.uniform(-1.5, 1.5, (b, h, w))], -1)
            .reshape(b, h * w, 5).astype(np.float32))
    jm = JFRM(in_channels=32, points=points)
    jf = [jnp.asarray(f) for f in feats]
    jr = [jnp.asarray(r) for r in rois]
    v = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jf, jr))
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params'][name]['kernel'] *= 30
    want = jm.apply(v, jf, jr)
    tm = FeatureRefineModule(in_channels=32, points=points).eval()
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats], [t(r) for r in rois])
    for g, w in zip(got, want):
        assert_close(nhwc(g), w)


@pytest.mark.parametrize('points', [1, 5])
def test_frm_module_samples_all_levels_in_one_call(pyramid, points,
                                                   monkeypatch):
    """On the kernel route the FRM makes one frm_sample_levels call for
    its five levels (forced here on the CPU, where that call takes the
    plain form) and gives what its plain route gives."""
    feats = [nchw(f) for f in pyramid[2]]
    rng = np.random.RandomState(points)
    rois = [t(np.concatenate([rng.uniform(0, 64, (2, f.shape[1] * f.shape[2],
                                                  2)),
                              rng.uniform(8, 32, (2, f.shape[1] * f.shape[2],
                                                  2)),
                              rng.uniform(-1.5, 1.5, (2, f.shape[1]
                                                      * f.shape[2], 1))],
                             -1).astype(np.float32)) for f in pyramid[2]]
    tm = FeatureRefineModule(in_channels=32, points=points).eval()
    tm.load_state_dict(seeded_state_dict(tm, points))
    calls = []

    def spy(*args):
        calls.append(args)
        return frm_module.frm_sample_levels_reference(*args)
    monkeypatch.setattr(frm_module, 'frm_sample_levels', spy)
    monkeypatch.setattr(FeatureRefineModule, 'sample_route',
                        lambda self, feat: True)
    with torch.no_grad():
        got = tm(feats, rois)
    monkeypatch.undo()
    tm.kernels = False
    with torch.no_grad():
        want = tm(feats, rois)
    assert len(calls) == 1 and len(calls[0][0]) == 5
    assert calls[0][3:] == ([1 / s for s in (8, 16, 32, 64, 128)], points,
                            True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_seeded_state_dict_is_deterministic_and_complete():
    m = FPN(out_channels=16)
    a, b = seeded_state_dict(m, 3), seeded_state_dict(m, 3)
    assert a.keys() == m.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['lateral_0.weight'],
                           seeded_state_dict(m, 4)['lateral_0.weight'])


# ---------------------------------------------------------------------------
# core: anchors and coders
# ---------------------------------------------------------------------------

def test_anchors_match_jax():
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    kw = dict(strides=(8, 16, 32, 64, 128), ratios=(1.0, 0.5, 2.0),
              octave_base_scale=4, scales_per_octave=3)
    for got, want in zip(RAnchorGenerator(**kw).grid_anchors(sizes),
                         JAnchors(**kw).grid_anchors(sizes)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
def test_obb_coder_matches_jax(version):
    rng = np.random.RandomState({'v1': 0, 'v2': 1, 'v3': 2}[version])
    n = 64

    def boxes():
        return np.stack([rng.uniform(0, 500, n), rng.uniform(0, 500, n),
                         rng.uniform(5, 80, n), rng.uniform(5, 80, n),
                         rng.uniform(-math.pi / 2, math.pi / 2, n)],
                        -1).astype(np.float32)
    anchors, gt = boxes(), boxes()
    deltas = rng.normal(0, 1.5, (n, 5)).astype(np.float32)
    means, stds = (0.1, -0.1, 0.0, 0.2, 0.0), (0.5, 0.5, 1.0, 1.0, 0.3)
    jc = j_coders.DeltaXYWHAOBBoxCoder(means, stds, version)
    tc = coders.DeltaXYWHAOBBoxCoder(means, stds, version)
    np.testing.assert_allclose(
        tc.encode(t(anchors), t(gt)).numpy(),
        np.asarray(jc.encode(jnp.asarray(anchors), jnp.asarray(gt))),
        rtol=1e-5, atol=1e-5)
    kw = dict(max_shape=(300, 400)) if version == 'v1' else {}
    np.testing.assert_allclose(
        tc.decode(t(anchors), t(deltas), **kw).numpy(),
        np.asarray(jc.decode(jnp.asarray(anchors), jnp.asarray(deltas), **kw)),
        rtol=1e-5, atol=1e-4)
