"""The plain versions of the port's kernels K3 int8, K4, K5 and K5 int8 (and
the fused stem's plain form against K6) held to the JAX package's TPU
kernels, run in Pallas interpret mode on the CPU as the JAX package's own
tests run them; and the port's fused ``Bottleneck`` and unfused stem route
against their JAX modules. Inputs come from numpy seeds.

Tolerances (each the JAX package's own for the same pair, where it has one):
- K3 int8: within one bf16 ulp (exact int32 sums; f32 epilogue);
- K4: exact (max of bf16 values);
- K5 bf16: atol 0.05 (``tests/test_stem_pool.py``: f32 sums in another
  order, bf16 intermediates);
- K5 int8: atol 2e-2 (``tests/test_stem_pool.py``: exact int32 sums, f32
  epilogue rounding);
- K6: atol and rtol 2e-2 (``tests/test_stem_pool.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models.resnet import Bottleneck as JBottleneck
from r3det_tpu.ops import bottleneck_fuse as JB
from r3det_tpu.ops import stem_pool as JS
from r3det_tpu_torch.models.resnet import Bottleneck
from r3det_tpu_torch.ops import bottleneck_fuse as TB
from r3det_tpu_torch.ops import stem_pool as TS
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)
BF16_ULP = 2.0 ** -7        # bf16 keeps 8 significant bits


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def stem_inputs(seed, b=2, h=32, w=32):
    rng = np.random.RandomState(seed)
    x12 = rng.randn(b, h, w, 12).astype(np.float32)
    x12 = np.asarray(jnp.asarray(x12).astype(jnp.bfloat16), np.float32)
    k = (rng.randn(4, 4, 12, 64) * 0.1).astype(np.float32)
    s = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    return x12, k, s, bias


def test_stem_q8_plain_matches_pallas_interpret():
    """K3 int8's plain version against ``stem_conv_pool_s2d4_pallas(...,
    quantize=True)``, including the -inf pool edges."""
    x12, k, s, b = stem_inputs(11)
    want = JS.stem_conv_pool_s2d4_pallas(
        jnp.asarray(x12).astype(jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(s), jnp.asarray(b), interpret=True, quantize=True)
    got = TS.stem_conv_pool_q8_reference(t(x12).to(torch.bfloat16), t(k),
                                         t(s), t(b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    diff = np.abs(f32(got) - f32(want))
    assert (diff <= BF16_ULP * np.abs(f32(want)) + 1e-6).all(), diff.max()


def test_stem_q8_weight_scales_equal_the_folded_kernels():
    """Each sub-pixel group of the s2d4-folded kernel holds all 192 taps of
    the (4, 4, 12, 64) kernel, so its per-channel int8 scales and codes are
    those of the unfolded kernel, which the port quantizes."""
    _, k, _, _ = stem_inputs(3)
    k3 = np.asarray(JS.fold_stem_kernel_s2d4(jnp.asarray(k)))
    kscale = np.maximum(np.abs(k3).max((0, 1, 2)), 1e-8) / 127.0
    codes = np.clip(np.round(k3 / kscale), -127, 127)
    from r3det_tpu_torch.ops.int8_conv import quantize_weights
    ki, ks = quantize_weights(t(k), axes=(0, 1, 2))
    np.testing.assert_array_equal(kscale, np.tile(ks.reshape(-1).numpy(), 4))
    folded = np.asarray(JS.fold_stem_kernel_s2d4(
        jnp.asarray(ki.numpy().astype(np.float32))))
    np.testing.assert_array_equal(codes, folded)


def test_stem_pool_plain_matches_pallas_interpret():
    """K4's plain version (on the plain conv output) against
    ``pool_s2d4_pallas`` (on the s2d4 blocks of the same data)."""
    rng = np.random.RandomState(13)
    y = np.asarray(jnp.asarray(rng.randn(2, 16, 8, 256).astype(np.float32))
                   .astype(jnp.bfloat16), np.float32)
    want = JS.pool_s2d4_pallas(jnp.asarray(y).astype(jnp.bfloat16),
                               interpret=True)
    # channel group (dy * 2 + dx) of cell (i, j) is conv pixel (2i+dy, 2j+dx)
    b, hc, wc, _ = y.shape
    plain = y.reshape(b, hc, wc, 2, 2, 64).transpose(0, 1, 3, 2, 4, 5)
    plain = plain.reshape(b, 2 * hc, 2 * wc, 64)
    got = TS.stem_pool_reference(t(plain).to(torch.bfloat16))
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('quantize', [False, True])
def test_unfused_stem_matches_jax(dtype, quantize):
    """The unfused stem route against ``stem_conv_pool_s2d4``: f32 within
    1e-5 of the largest value (sums in another order; XLA's FMA), bf16
    within one bf16 ulp plus, for the float conv, 2e-2 (its f32 sums round
    a few bf16 outputs the other way, the JAX package's own bound).

    JAX runs op by op here: under ``jit`` XLA's CPU compiler folds the int8
    conv's bf16 output and the convert back to f32 into an f32 output, so
    the int32 sums skip the bf16 rounding that the function (and the TPU)
    has; the port keeps it."""
    x12, k, s, b = stem_inputs(7 + quantize)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = f32(JS.stem_conv_pool_s2d4(
        jnp.asarray(x12).astype(jd), jnp.asarray(k), jnp.asarray(s),
        jnp.asarray(b), dtype=jd, quantize=quantize))
    for pool_kernel in (False, True):
        got = TS.stem_conv_pool_unfused(t(x12).to(td), t(k), t(s), t(b),
                                        dtype=td, quantize=quantize,
                                        pool_kernel=pool_kernel)
        assert got.dtype == td and tuple(got.shape) == want.shape
        diff = np.abs(f32(got) - want)
        if dtype == 'float32':
            assert diff.max() <= 1e-5 * np.abs(want).max()
        else:
            tol = BF16_ULP * np.abs(want) + (0 if quantize else 2e-2)
            assert (diff <= tol + 1e-6).all(), diff.max()


def bottleneck_weights(seed, f=16):
    r = np.random.RandomState(seed)
    c4 = 4 * f
    x = np.asarray(jnp.asarray(r.normal(0, 1, (2, 16, 24, c4))
                               .astype(np.float32)).astype(jnp.bfloat16),
                   np.float32)
    ws = [r.normal(0, 0.1, shape).astype(np.float32) for shape in (
        (1, 1, c4, f), (f,), (3, 3, f, f), (f,), (1, 1, f, c4), (c4,))]
    return x, ws


def test_fused_bottleneck_plain_matches_pallas_interpret():
    x, ws = bottleneck_weights(3)
    want = JB.fused_bottleneck(jnp.asarray(x).astype(jnp.bfloat16),
                               *map(jnp.asarray, ws), interpret=True)
    got = TB.fused_bottleneck_reference(t(x).to(torch.bfloat16),
                                        *map(t, ws))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=0.05)


def test_fused_bottleneck_q8_plain_matches_pallas_interpret():
    x, ws = bottleneck_weights(5)
    amax = [np.float32(np.abs(x).max()), np.float32(1.5), np.float32(1.2)]
    want = JB.fused_bottleneck_q8(jnp.asarray(x).astype(jnp.bfloat16),
                                  *map(jnp.asarray, ws + amax),
                                  interpret=True)
    got = TB.fused_bottleneck_q8_reference(t(x).to(torch.bfloat16),
                                           *map(t, ws + amax))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-2)
    # the XLA oracle has the same grids: equal up to f32 epilogue rounding
    oracle = JB.fused_bottleneck_q8_xla(jnp.asarray(x).astype(jnp.bfloat16),
                                        *map(jnp.asarray, ws + amax))
    np.testing.assert_allclose(f32(got), f32(oracle), rtol=0, atol=2e-2)


def test_fold_bn_matches_jax():
    r = np.random.RandomState(2)
    args = [r.normal(0, 1, (3, 3, 8, 16)).astype(np.float32),
            r.uniform(0.5, 1.5, 16).astype(np.float32),
            r.normal(0, 1, 16).astype(np.float32),
            r.normal(0, 1, 16).astype(np.float32),
            r.uniform(0.5, 1.5, 16).astype(np.float32)]
    for g, w in zip(TB.fold_bn(*map(t, args)),
                    JB.fold_bn(*map(jnp.asarray, args))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize('variant', ['bf16', 'q8'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_bottleneck_module_matches_jax(variant, dtype):
    """``Bottleneck(fused=True)`` (and with ``quantize='static'``) against
    the JAX module, which takes its XLA branch on the CPU; the fused block
    computes in bf16 and casts back to the model dtype."""
    quantize = 'static' if variant == 'q8' else False
    r = np.random.RandomState(6)
    x = np.asarray(jnp.asarray(r.normal(0, 1, (1, 16, 16, 64))
                               .astype(np.float32)).astype(jnp.bfloat16),
                   np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JBottleneck(16, stride=1, quantize=quantize, dtype=jd)
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(2),
                                       jnp.asarray(x, jd)))
    v['batch_stats'] = jax.tree.map(
        lambda a: a + np.abs(r.normal(0, 0.3, a.shape)).astype(np.float32),
        v['batch_stats'])
    if quantize:
        _, mut = jm.apply(v, jnp.asarray(x, jd), mutable=['quant_stats'])
        v['quant_stats'] = jax.tree.map(np.array, mut['quant_stats'])
    want = jax.jit(JBottleneck(16, stride=1, quantize=quantize, fused=True,
                               dtype=jd).apply)(v, jnp.asarray(x, jd))
    tm = Bottleneck(64, 16, quantize=quantize, fused=True).eval()
    # from_flax keys on tree paths: nest the block as a model would
    sd = from_flax({c: {'layer1_1': tree} for c, tree in v.items()})
    tm.load_state_dict({k[len('layer1_1.'):]: a for k, a in sd.items()},
                       strict=True)
    assert tm.can_fuse(t(x).permute(0, 3, 1, 2))
    with torch.no_grad():
        got = tm(t(x).to(td).permute(0, 3, 1, 2))
    assert got.dtype == td
    atol = 2e-2 if quantize else 0.05
    np.testing.assert_allclose(f32(got.permute(0, 2, 3, 1)), f32(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize('kernel', ['stem_conv_pool_pallas',
                                    'stem_conv_pool_pallas_grouped'])
def test_k6_matches_port_stem_reference(kernel):
    """The TPU kernels K6 and K6g compute the bf16 fused stem that K3's CUDA
    kernel serves: held to the port's plain stem."""
    x12, k, s, b = stem_inputs(5, b=1, h=32, w=16)
    want = getattr(JS, kernel)(jnp.asarray(x12), jnp.asarray(k),
                               jnp.asarray(s), jnp.asarray(b),
                               interpret=True)
    got = TS.stem_conv_pool_reference(t(x12), t(k), t(s), t(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
