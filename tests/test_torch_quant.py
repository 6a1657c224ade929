"""The port's int8 serving path (r3det_tpu_torch.models.quant and the int8
options of the detector) against the JAX package, on the CPU, in float32
unless a test says otherwise. Inputs and weights come from numpy seeds;
weights cross over through ``utils/convert.py::from_flax``.

Tolerances:
- ``QConv`` alone: 1e-6 of the largest magnitude. The int32 sums are exact
  on both sides and the dequant runs in the same order.
- ``calibrate``: every ``act_absmax`` and ``in_absmax`` within 1e-6
  relative, each layer fed the same calibrated-path inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from r3det_tpu.models import quant as JQ
from r3det_tpu_torch.models import quant as TQ
from r3det_tpu_torch.ops.int8_conv import int8_conv_nhwc

torch.set_num_threads(2)

# (kernel, strides, padding) of the port's QConvs: head/FPN 3x3, the
# strided downsample 1x1, the strided FPN extra 3x3, FRM's 1x5 and 5x1
CONVS = {
    '3x3': ((3, 3), (1, 1), (1, 1)),
    '1x1s2': ((1, 1), (2, 2), (0, 0)),
    '3x3s2': ((3, 3), (2, 2), (1, 1)),
    '1x5': ((1, 5), (1, 1), (0, 2)),
    '5x1': ((5, 1), (1, 1), (2, 0)),
}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def qconv_pair(conv, seed, use_bias=True):
    (kh, kw), strides, (ph, pw) = CONVS[conv]
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (2, 12, 10, 16)).astype(np.float32)
    jm = JQ.QConv(24, (kh, kw), strides=strides,
                  padding=[(ph, ph), (pw, pw)], use_bias=use_bias,
                  dtype=jnp.float32)
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x)))
    if use_bias:
        v['params']['bias'] = rng.normal(0, 0.5, 24).astype(np.float32)
    tm = TQ.QConv(16, 24, (kh, kw), stride=strides, padding=(ph, pw),
                  bias=use_bias)
    with torch.no_grad():
        tm.weight.copy_(t(v['params']['kernel'].transpose(3, 2, 0, 1)))
        if use_bias:
            tm.bias.copy_(t(v['params']['bias']))
    return x, jm, v, tm


@pytest.mark.parametrize('conv', list(CONVS))
@pytest.mark.parametrize('mode', ['dynamic', 'static', 'prequant'])
def test_qconv_matches_jax(conv, mode):
    x, jm, v, tm = qconv_pair(conv, seed=len(conv) + len(mode))
    xn = np.abs(x).max()
    if mode == 'static':
        # a calibrated range below max|x| exercises the clip
        v['quant_stats']['act_absmax'] = np.float32(0.7 * xn)
        tm.static_scale = True
        jm = jm.clone(static_scale=True)
    with torch.no_grad():
        tm.act_absmax.fill_(float(v['quant_stats']['act_absmax']))
    if mode == 'prequant':
        ascale = np.float32(xn) / np.float32(127.0)
        xi = np.clip(np.round(x / ascale), -127, 127).astype(np.int8)
        want = jm.apply(v, (jnp.asarray(xi), jnp.asarray(ascale)))
        got = tm((t(xi), torch.tensor(ascale)), torch.float32)
    else:
        want = jm.apply(v, jnp.asarray(x))
        got = tm(t(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    assert_close(got, want, 1e-6)


def test_qconv_bf16_matches_jax():
    """bf16 model: int32 sums rounded to bf16 before the dequant (the JAX
    package's bf16 conv output), result bf16: within one bf16 ulp of the
    largest magnitude."""
    x, jm, v, tm = qconv_pair('3x3', seed=9)
    jm = jm.clone(dtype=jnp.bfloat16)
    want = jm.apply(v, jnp.asarray(x).astype(jnp.bfloat16))
    got = tm(t(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got.permute(0, 2, 3, 1).float().detach().numpy(), want,
                 2.0 ** -8)


def test_calibrate_records_running_max_over_calls():
    """One QConv called on three inputs (as a head tower runs on each
    pyramid level) records the largest max|x| (JAX: one mutable apply)."""
    _, jm, v, tm = qconv_pair('3x3', seed=3)
    # flax's init recorded max|x| of its input: calibration starts there
    with torch.no_grad():
        tm.act_absmax.fill_(float(v['quant_stats']['act_absmax']))
    rng = np.random.RandomState(4)
    xs = [rng.normal(0, s, (1, 6, 6, 16)).astype(np.float32)
          for s in (1.0, 3.0, 0.5)]

    class Thrice(nn.Module):
        @nn.compact
        def __call__(self, xs):
            conv = JQ.QConv(24, (3, 3), padding=[(1, 1), (1, 1)],
                            use_bias=True, dtype=jnp.float32)
            return [conv(x) for x in xs]
    jt = Thrice()
    jv = {'params': {'QConv_0': v['params']},
          'quant_stats': {'QConv_0': v['quant_stats']}}
    want_out, mut = jt.apply(jv, [jnp.asarray(x) for x in xs],
                             mutable=['quant_stats'])
    want = float(mut['quant_stats']['QConv_0']['act_absmax'])

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tm

        def forward(self, xs):
            return [self.conv(x) for x in xs]
    w = Wrap()
    outs = []
    w.register_forward_hook(lambda m, i, o: outs.append(o))
    TQ.calibrate(w, [[t(x).permute(0, 3, 1, 2) for x in xs]])
    assert not tm.calibrating
    np.testing.assert_allclose(float(tm.act_absmax), want, rtol=1e-6)
    # during calibration each call quantizes with the running max so far
    for g, wnt in zip(outs[0], want_out):
        assert_close(g.permute(0, 2, 3, 1).numpy(), wnt, 1e-6)


def test_int8_conv_is_exact():
    """int8 im2col + int matmul against an int64 reference, sums past 2^24
    (where an f32 conv of the codes would round)."""
    rng = np.random.RandomState(0)
    xi = rng.randint(-127, 128, (2, 7, 9, 1024)).astype(np.int8)
    wi = rng.randint(-127, 128, (3, 3, 1024, 8)).astype(np.int8)
    xi[0] = 127
    wi[..., 0] = 127              # image 0, channel 0: 9 * 1024 * 127^2
    got = int8_conv_nhwc(t(xi), t(wi), (2, 1), ((1, 1), (1, 1)))
    xp = np.pad(xi.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros(tuple(got.shape), np.int64)
    for ky in range(3):
        for kx in range(3):
            want += np.einsum('bhwc,co->bhwo',
                              xp[:, ky:ky + 7:2, kx:kx + 9], wi[ky, kx]
                              .astype(np.int64))
    assert int(want.max()) > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)
