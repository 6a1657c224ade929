"""The bf16 conv epilogue (``ops/conv_epilogue.py``) and the bottleneck's
route through it (``Bottleneck.epilogue_forward``), on the CPU.

- The plain form, in its explicit f32-then-bf16 roundings, equals the
  unfused ops of ``Bottleneck.forward`` (``FrozenBN.forward``, the residual
  add, ``F.relu``) bit for bit in bf16, for each variant and with NaN,
  +-inf, -0.0 and overflowing inputs: that plain form is what the CUDA
  kernel is held to on the card.
- The route engages only for a bf16 block on a card with the kernels
  switched on, gradients off, not quantized and not taking K5; the
  route's inputs are given here as flags.
- Forced onto its route (on the CPU it runs the plain form), a block and a
  whole ResNet-50 equal their unfused route bit for bit, and a traced
  ResNet-50 call records one ``r3det.backbone.epilogue`` span a conv
  epilogue: 48.
"""
import types

import pytest
import torch

from r3det_tpu_torch.models.resnet import Bottleneck, FrozenBN, ResNet
from r3det_tpu_torch.ops import conv_epilogue as E
from r3det_tpu_torch.ops.route import kernels
from r3det_tpu_torch.utils.convert import seeded_state_dict

from program_spans import traced

torch.set_num_threads(2)
BF16 = torch.bfloat16


def nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


def special(gen, shape):
    """A channels_last bf16 tensor of normal values with NaN, +-inf, +-0.0
    and large values (overflow once scaled) at random places."""
    x = torch.randn(shape, generator=gen)
    pick = torch.randint(0, 12, shape, generator=gen)
    for code, v in enumerate((float('nan'), float('inf'), -float('inf'),
                              -0.0, 0.0, 3e38, -3e38)):
        x = torch.where(pick == code, torch.full_like(x, v), x)
    return nhwc(x.to(BF16))


def frozen_bn(gen, c):
    """A FrozenBN whose affine has zero, negative and huge scales and
    -0.0 offsets beside ordinary ones."""
    bn = FrozenBN(c)
    with torch.no_grad():
        bn.scale.copy_(torch.randn(c, generator=gen))
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.mean.copy_(torch.randn(c, generator=gen))
        bn.var.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.scale[0] = 0.0
        bn.scale[1] = 1e30                    # inv overflows bf16's range
        bn.scale[2:4] = 1.0                   # b = -0.0: bias -0, mean 0
        bn.bias[2:4] = -0.0
        bn.mean[2:4] = 0.0
    return bn


def same_bits(got, want):
    """Equal bit for bit, NaN where NaN (any NaN payload)."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(g[~nan], w[~nan])


VARIANTS = ('affine', 'identity', 'downsample')


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'no_relu'])
@pytest.mark.parametrize('variant', VARIANTS)
def test_plain_form_equals_unfused_ops(variant, relu):
    gen = torch.Generator().manual_seed(VARIANTS.index(variant))
    shape, c = (2, 64, 5, 6), 64
    a, r, d = (special(gen, shape) for _ in range(3))
    bn, bn_d = frozen_bn(gen, c), frozen_bn(gen, c)
    with torch.no_grad():
        want = bn(a)
        residual = None
        if variant == 'identity':
            want, residual = want + r, r
        elif variant == 'downsample':
            want = want + bn_d(d)
            residual = (d, *bn_d.affine(BF16))
        # NaN, inf and -0.0 reach the ReLU
        assert torch.isnan(want).any() and torch.isinf(want).any()
        assert (want.view(torch.int16) == -2 ** 15).any()
        want = torch.relu(want) if relu else want
        got = E.conv_epilogue_reference(a, *bn.affine(BF16), residual, relu)
    same_bits(got, want)
    same_bits(E.conv_epilogue(a, *bn.affine(BF16), residual, relu), want)


def flags(is_cuda=True, dtype=BF16, h=16):
    return types.SimpleNamespace(
        is_cuda=is_cuda, dtype=dtype, shape=(2, 256, h, 16),
        device=torch.device('cuda' if is_cuda else 'cpu'),
        requires_grad=False)


# (block options, input flags, gradients on, kernels on, expected route)
ROUTE_CASES = {
    'bf16_card': ({}, flags(), False, True, True),
    'autograd': ({}, flags(), True, True, False),
    'f32': ({}, flags(dtype=torch.float32), False, True, False),
    'cpu': ({}, flags(is_cuda=False), False, True, False),
    'kernels_off': ({}, flags(), False, False, False),
    'quantize': (dict(quantize=True), flags(), False, True, False),
    'quantize_static': (dict(quantize='static'), flags(), False, True,
                        False),
    'k5_block': (dict(fused=True), flags(), False, True, False),
    'k5_off_for_h': (dict(fused=True), flags(h=12), False, True, True),
    'k5_off_for_stride': (dict(fused=True, stride=2), flags(), False, True,
                          True),
}


@pytest.mark.parametrize('case', list(ROUTE_CASES))
def test_epilogue_route_engages_only_as_specified(case):
    options, x, grad, on, expected = ROUTE_CASES[case]
    block = Bottleneck(256, 64, **options)
    with torch.set_grad_enabled(grad), kernels(on):
        assert block.epilogue_route(x) == expected


def seeded(module, seed):
    """Seeded conv weights and FrozenBNs away from the identity."""
    module.load_state_dict(seeded_state_dict(module, seed))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBN):
                c = m.scale.numel()
                m.scale.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)
    return module


def forced(fn, monkeypatch):
    """``fn()`` with every Bottleneck forced onto its epilogue route (on
    the CPU the route runs the plain form)."""
    monkeypatch.setattr(Bottleneck, 'epilogue_route', lambda self, x: True)
    try:
        return fn()
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize('inplanes,features,stride', [
    (256, 64, 1), (64, 64, 1), (256, 128, 2)],
    ids=['identity', 'downsample', 'downsample_s2'])
def test_block_route_equals_unfused(inplanes, features, stride, monkeypatch):
    block = seeded(Bottleneck(inplanes, features, stride), 3)
    x = nhwc(torch.randn(2, inplanes, 12, 10,
                         generator=torch.Generator().manual_seed(5)).to(BF16))
    with torch.no_grad():
        want = block(x)
        got = forced(lambda: block(x), monkeypatch)
    same_bits(got, want)


def test_resnet50_route_equals_unfused_and_counts_spans(monkeypatch):
    """Forced onto the route, a ResNet-50 call makes one epilogue call a
    conv epilogue, 48, equal to the unfused route bit for bit; the
    backbone records no span of its own (the detector's ``backbone`` span
    is around it)."""
    net = seeded(ResNet(depth=50, dtype=BF16), 7)
    images = torch.randn(1, 64, 64, 3,
                         generator=torch.Generator().manual_seed(1))
    calls = []
    real = E.conv_epilogue
    with torch.no_grad():
        want, spans_off = traced(lambda: net(images))
        monkeypatch.setattr(E, 'conv_epilogue',
                            lambda *a: calls.append(1) or real(*a))
        got, spans = traced(lambda: forced(lambda: net(images), monkeypatch))
    for g, w in zip(got, want):
        same_bits(g, w)
    assert len(calls) == 48
    assert not spans and not spans_off
