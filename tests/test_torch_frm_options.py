"""The FRM build options ``frm_fuse_convs`` and ``frm_sample_kernel``
against the JAX package, on the CPU.

- ``frm_fuse_convs``: the tiny f32 R3Det (tests/test_torch_detector.py's,
  the same flax weights through ``from_flax``) within 1e-4 of each
  tensor's largest magnitude of JAX's fused model (f32 convs summed in
  another order); the FRM alone with ``quantize`` too, whose fused convs
  are plain convs in both packages.
- ``frm_sample_kernel``: every value gives the default model's outputs bit
  for bit (K2 replaces both TPU routes).
- bf16: the port's plain sample (f32 corner weights) within 1 bf16 ulp of
  JAX's ``sample_kernel='stencil'`` route, which keeps f32 weights too;
  JAX's default gather rounds the weights to bf16 first, and its distance
  from the port is printed and recorded (``record_property``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models import detectors as J
from r3det_tpu.models.frm import FeatureRefineModule as JFRM
from r3det_tpu.models.frm import feature_refine_sample as j_frs
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.models.frm import SAMPLE_KERNELS
from r3det_tpu_torch.models.frm import FeatureRefineModule as TFRM
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)

SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
STRIDES = (8, 16, 32, 64, 128)
J_CFG = J.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=J.TestCfg(nms_pre=64, max_per_img=16))
T_CFG = T.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, test=T.TestCfg(nms_pre=64, max_per_img=16))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope='module')
def weights():
    """Images and flax weights of the tiny R3Det (FRM convs scaled up so
    that the branch matters)."""
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = J.build_detector(J_CFG, dtype=jnp.float32)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params']['frm_0'][name]['kernel'] *= 30
        v['params']['frm_0'][name]['bias'] += rng.normal(
            0, 0.5, v['params']['frm_0'][name]['bias'].shape)
    return images, v


def port(v, **kw):
    m = T.build_detector(T_CFG, dtype=torch.float32, device='cpu', **kw)
    m.load_state_dict(from_flax(v), strict=True)
    return m


def test_fuse_convs_model_matches_jax(weights):
    images, v = weights
    model = J.build_detector(J_CFG, dtype=jnp.float32, frm_fuse_convs=True)
    want = jax.jit(model.apply)(v, jnp.asarray(images))
    m = port(v, frm_fuse_convs=True)
    with torch.no_grad():
        got = m(t(images))
        plain = port(v)(t(images))
    for w_lvls, g_lvls in zip(want['sr'][0], got['sr'][0]):
        for w, g in zip(w_lvls, g_lvls):
            assert_close(g.numpy(), w)
    # the composition is the unfused branch's function, its f32 sums in
    # another order (through the scaled-up FRM and the refine head: 1e-3)
    for a, b in zip(got['sr'][0][0], plain['sr'][0][0]):
        assert_close(a.numpy(), b.numpy(), rtol=1e-2)
    assert not any(torch.equal(a, b)
                   for a, b in zip(got['sr'][0][0], plain['sr'][0][0]))


def frm_inputs(rng, b=2, c=32):
    """NHWC level features (16, 8, 4, 2, 1) and rois near each cell's
    centre in image coordinates."""
    feats, rois = [], []
    for (h, w), s in zip(((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)),
                         STRIDES):
        feats.append(rng.randn(b, h, w, c).astype(np.float32))
        jj, ii = np.meshgrid(np.arange(w), np.arange(h))
        r = np.stack([jj * s + rng.uniform(-20, 20, (b, h, w)),
                      ii * s + rng.uniform(-20, 20, (b, h, w)),
                      rng.uniform(8, 64, (b, h, w)),
                      rng.uniform(8, 64, (b, h, w)),
                      rng.uniform(-1.5, 1.5, (b, h, w))], -1)
        rois.append(r.reshape(b, h * w, 5).astype(np.float32))
    return feats, rois


@pytest.mark.parametrize('quantize', [False, True])
def test_fuse_convs_frm_matches_jax(quantize):
    """The FRM alone on the same inputs: under ``quantize`` the fused
    convs are plain convs in both packages (no int8 rounding)."""
    rng = np.random.RandomState(1)
    feats, rois = frm_inputs(rng)
    jm = JFRM(in_channels=32, fuse_convs=True, quantize=quantize,
              dtype=jnp.float32)
    jf = [jnp.asarray(f) for f in feats]
    jr = [jnp.asarray(r) for r in rois]
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(1), jf, jr))
    assert set(v) == {'params'}              # no int8 ranges
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params'][name]['kernel'] *= 30
        v['params'][name]['bias'] += rng.normal(0, 0.5, (32,))
    want = jm.apply(v, jf, jr)
    tm = TFRM(in_channels=32, fuse_convs=True, quantize=quantize)
    tm.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = tm([t(f).permute(0, 3, 1, 2) for f in feats],
                 [t(r) for r in rois])
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_sample_kernel_values_equal_the_default(weights):
    images, v = weights
    with torch.no_grad():
        base = port(v)(t(images))
        for value in SAMPLE_KERNELS[1:]:
            m = port(v, frm_sample_kernel=value)
            assert m.frm_0.sample_kernel == value
            out = m(t(images))
            for a, b in zip(out['sr'][0][0] + out['sr'][0][1],
                            base['sr'][0][0] + base['sr'][0][1]):
                assert torch.equal(a, b)
    with pytest.raises(ValueError):
        T.build_detector(T_CFG, device='cpu', frm_sample_kernel='gather')


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize('quirk', [True, False])
def test_bf16_sample_within_an_ulp_of_the_stencil_route(quirk,
                                                        record_property):
    rng = np.random.RandomState(2)
    b, h, w, c, stride = 2, 16, 16, 32, 8
    feat = rng.randn(b, h, w, c).astype(np.float32)
    feat = np.asarray(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32))
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    rois = np.stack([jj * stride + rng.uniform(-6, 6, (b, h, w)),
                     ii * stride + rng.uniform(-6, 6, (b, h, w)),
                     rng.uniform(8, 64, (b, h, w)),
                     rng.uniform(8, 64, (b, h, w)),
                     rng.uniform(-1.5, 1.5, (b, h, w))], -1)
    rois = rois.reshape(b, h * w, 5).astype(np.float32)
    jfeat = jnp.asarray(feat, jnp.bfloat16)
    routes = {k: np.asarray(j_frs(jfeat, jnp.asarray(rois), 1.0 / stride,
                                  1, quirk, sample_kernel=k)
                            .astype(jnp.float32))
              for k in ('stencil', False)}
    got = K2.feature_refine_sample(t(feat).bfloat16(), t(rois), 1.0 / stride,
                                   1, quirk).float().numpy()
    ulp = bf16_ulp(routes['stencil'])
    err = np.abs(got - routes['stencil'])
    assert (err <= ulp).all(), float((err / ulp).max())
    gap = np.abs(got - routes[False])
    ulps = gap / bf16_ulp(np.maximum(np.abs(got), np.abs(routes[False])))
    msg = (f'bf16 FRM sample, port vs JAX default gather (bf16 corner '
           f'weights): max |diff| {gap.max():.6g}, {ulps.max():.1f} bf16 '
           f'ulps, {(gap > 0).mean():.4f} of values differ')
    print(msg)
    record_property('gather_gap', msg)
    assert np.isfinite(gap).all()
