"""The port's int8 serving path (r3det_tpu_torch.models.quant and the int8
options of the detector) against the JAX package, on the CPU, in float32
unless a test says otherwise. Inputs and weights come from numpy seeds;
weights cross over through ``utils/convert.py::from_flax``.

Tolerances:
- ``QConv`` alone: 1e-6 of the largest magnitude. The int32 sums are exact
  on both sides and the dequant runs in the same order.
- ``calibrate``: every ``act_absmax`` and ``in_absmax`` within 1e-6
  relative, each layer fed the same calibrated-path inputs.
- the fused conv's plain version against the unfused modules' ops, in
  bf16: bit-equal (the same ops in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from r3det_tpu.models import quant as JQ
from r3det_tpu_torch.models import quant as TQ
from r3det_tpu_torch.models.resnet import FrozenBN
from r3det_tpu_torch.ops import int8_conv as Q
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
        with torch.no_grad():           # QConv has no backward
            got = tm((t(xi), torch.tensor(ascale)), torch.float32)
    else:
        want = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
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
    with torch.no_grad():               # QConv has no backward
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


# the fused epilogues of the serving path: (kernel, Ci, Co, epilogue)
EPILOGUES = {
    'affine_relu_int8': ((1, 1), 32, 16, dict(affine=True, relu=True,
                                               out=True)),
    'affine_bf16': ((1, 1), 32, 32, dict(affine=True)),
    'affine_res_relu': ((1, 1), 16, 32, dict(affine=True, res='bf16',
                                              relu=True)),
    'affine_res8_relu': ((1, 1), 16, 32, dict(affine=True, res='int8',
                                               relu=True)),
    'relu_int8': ((3, 3), 32, 32, dict(relu=True, out=True, bias=True)),
    'relu_bf16': ((3, 3), 16, 16, dict(relu=True, bias=True)),
}


@pytest.mark.parametrize('name', list(EPILOGUES))
def test_qconv_fused_matches_unfused_modules(name):
    """``qconv_fused`` on CPU tensors (its plain version) against the ops
    the unfused modules run, NCHW channels_last as in the model: QConv's
    int8 conv, FrozenBN, the residual add (int8 codes dequantized as
    ``Bottleneck.int8_act`` does), ReLU, the next conv's quantize."""
    (kh, kw), ci, co, spec = EPILOGUES[name]
    rng = np.random.RandomState(len(name))
    bf16 = torch.bfloat16
    x = t(rng.normal(0, 1, (2, 9, 7, ci)).astype(np.float32)).to(bf16)
    ascale = x.float().abs().amax() / 127.0
    wi, ks = Q.quantize_weights(
        t(rng.normal(0, 0.2, (kh, kw, ci, co)).astype(np.float32)), (0, 1, 2))
    bias = t(rng.normal(0, 1, co).astype(np.float32)) \
        if spec.get('bias') else None
    pad = (kh // 2, kw // 2)
    y = Q.qconv_reference(x, ascale, wi, ks.reshape(-1), bias, (1, 1), pad,
                          bf16).permute(0, 3, 1, 2)
    kw_ = dict(relu=spec.get('relu', False))
    if spec.get('affine'):
        bn = FrozenBN(co)
        with torch.no_grad():
            for prm, (lo, hi) in ((bn.scale, (0.5, 2)), (bn.bias, (-1, 1)),
                                  (bn.mean, (-1, 1)), (bn.var, (0.5, 2))):
                prm.copy_(t(rng.uniform(lo, hi, co).astype(np.float32)))
            y = bn(y)
        kw_['affine'] = bn.affine(bf16)
    if spec.get('res'):
        r = t(rng.normal(0, 2, (2, 9, 7, co)).astype(np.float32)).to(bf16)
        if spec['res'] == 'int8':
            rs = r.float().abs().amax() / 127.0
            codes = Q.quantize_act(r, rs)
            kw_['residual'] = (codes, rs)
            r = (codes.float() * rs).to(bf16)
        else:
            kw_['residual'] = r
        y = y + r.permute(0, 3, 1, 2)
    if spec.get('relu'):
        y = torch.nn.functional.relu(y)
    want = y.permute(0, 2, 3, 1)
    if spec.get('out'):
        kw_['out_scale'] = torch.tensor(2.5) / 127.0
        want = Q.quantize_act(want, kw_['out_scale'])
    with torch.no_grad():
        got = Q.qconv_fused(x, ascale, wi, ks.reshape(-1), bias, (1, 1), pad,
                            **kw_)
    if spec.get('out'):
        got, scale = got
        assert got.dtype == torch.int8 and scale is kw_['out_scale']
    else:
        assert got.dtype == bf16
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize('kernel,ci,co', [((3, 3), 64, 256), ((1, 5), 32, 64),
                                          ((1, 1), 128, 128)])
def test_pack_weights_layout(kernel, ci, co):
    """The kernel's weight layout: slice (n tile, chunk, ky, kx) holds one
    ck-byte row per output channel, its 16-byte pieces swizzled."""
    rng = np.random.RandomState(ci + co)
    wi = t(rng.randint(-127, 128, kernel + (ci, co)).astype(np.int8))
    packed = Q.pack_weights(wi)
    nb, nc, kh, kw, bn, ck = packed.shape
    assert (kh, kw, nb * bn, nc * ck) == kernel + (co, ci)
    assert bn == (256 if co % 256 == 0 else 128 if co % 128 == 0 else 64)
    assert ck == (64 if ci % 64 == 0 else 32)
    idx = rng.randint(0, 1 << 30, (200, 6)) % np.array(packed.shape)
    for nt, c, ky, kx, n, k in idx:
        swz = (n >> 1) & 3 if ck == 64 else (n >> 2) & 1
        assert packed[nt, c, ky, kx, n, ((k // 16) ^ swz) * 16 + k % 16] == \
            wi[ky, kx, c * ck + k, nt * bn + n]


def test_reciprocal_quantize_rule_matches_division():
    """The int8 conv kernel quantizes by the reciprocal product and takes
    the IEEE divide only within 4 ulp of a .5 boundary (``codes16`` in
    ``csrc/int8_conv.cu``); the same rule in float32 gives
    ``clip(rint(x / s), +-127)`` on bf16 values, including values next to
    ties, for scales over seven decades."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    for trial in range(40):
        s = f32(10 ** rng.uniform(-7, 0))
        k = rng.randint(-130, 130, 50000)
        x = np.concatenate([rng.normal(0, 60 * float(s), 50000),
                            (k + 0.5) * float(s)]).astype(np.float32)
        x = t(x).to(torch.bfloat16).float().numpy()
        want = np.clip(np.rint(x / s), -127, 127)
        y = x * (f32(1) / s)
        near = np.abs(y - np.floor(y) - f32(0.5)) <= \
            np.abs(y) * f32(6e-7) + f32(3e-7)
        got = np.clip(np.rint(np.where(near, x / s, y)), -127, 127)
        np.testing.assert_array_equal(got, want)
