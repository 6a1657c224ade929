"""The port's kernel routes and the stem kernel's weight pack, on the CPU.

- Each module that routes to a kernel (the fused stem, ``QConv``, the FRM
  sample) takes it only for a bf16 model on a card, and the plain form for
  an f32 model, so that an f32 model runs on a card. The routes read
  ``is_cuda`` and ``dtype`` of their input, given here as flags.
- ``pack_stem``, the K3 kernel's operands: unpacked in torch they give
  back the HWIO kernel (bf16) or the int8 codes and scales, and the plain
  conv on the unpacked weights gives the plain stem exactly.
- ``ResNet.stem_pack`` is made once and made again after an in-place
  weight update.
"""
import types

import numpy as np
import pytest
import torch

from r3det_tpu_torch.models.frm import FeatureRefineModule
from r3det_tpu_torch.models.quant import QConv
from r3det_tpu_torch.models.resnet import ResNet
from r3det_tpu_torch.ops import stem_pool as K3
from r3det_tpu_torch.ops.int8_conv import (int8_conv_nhwc, quantize_act,
                                           quantize_weights)

torch.set_num_threads(2)


def flags(is_cuda, dtype):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


def route(module, is_cuda, dtype):
    """The route predicate of ``module`` for an input with these flags."""
    x = flags(is_cuda, dtype)
    if module == 'stem':
        return ResNet(depth=10, dtype=dtype).stem_kernel_route(x)
    if module == 'qconv':
        return QConv(8, 8, 1).kernel_route(x, dtype)
    return FeatureRefineModule(in_channels=8).sample_route(x)


@pytest.mark.parametrize('module', ['stem', 'qconv', 'frm'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_route_takes_kernel_only_for_bf16_on_a_card(module, dtype):
    assert route(module, True, dtype) == (dtype == torch.bfloat16)
    assert not route(module, False, dtype)


@pytest.mark.parametrize('module', ['stem', 'qconv', 'frm'])
def test_route_off_without_kernels(module):
    x = flags(True, torch.bfloat16)
    if module == 'stem':
        m = ResNet(depth=10, dtype=torch.bfloat16, kernels=False)
        assert not m.stem_kernel_route(x)
    elif module == 'qconv':
        m = QConv(8, 8, 1, kernels=False)
        assert not m.kernel_route(x, torch.bfloat16)
    else:
        m = FeatureRefineModule(in_channels=8, kernels=False)
        assert not m.sample_route(x)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_frm_route_covers_points_5(dtype):
    """The five-point FRM takes the kernel on the same terms as points=1."""
    m = FeatureRefineModule(in_channels=8, points=5)
    assert m.sample_route(flags(True, dtype)) == (dtype == torch.bfloat16)
    assert not m.sample_route(flags(False, dtype))
    m.kernels = False
    assert not m.sample_route(flags(True, torch.bfloat16))


def stem_inputs(seed, shape=(2, 18, 22, 12)):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rng.uniform(-2, 2, shape)).to(torch.bfloat16),
            t(rng.normal(0, 0.1, (4, 4, 12, 64))),
            t(rng.uniform(0.5, 2, 64)), t(rng.uniform(-1, 1, 64)))


def unpack_bf16(pack):
    """[ky][co][kx * 12 + ci] (56 a row, 48 used) -> HWIO."""
    w = pack.weights
    assert w.shape == (4, 64, K3.BF16_ROW) and w.dtype == torch.bfloat16
    assert not w[..., 48:].any()
    return w[..., :48].permute(0, 2, 1).reshape(4, 4, 12, 64)


def unpack_q8(pack):
    """[ky][co][kx * 16 + ci] (80 a row, ci < 12 used) -> HWIO codes."""
    w = pack.weights
    assert w.shape == (4, 64, K3.Q8_ROW) and w.dtype == torch.int8
    assert not w[..., 64:].any()
    w = w[..., :64].reshape(4, 64, 4, 16)
    assert not w[..., 12:].any()
    return w[..., :12].permute(0, 2, 3, 1)


def test_stem_pack_bf16_unpacks_to_kernel():
    x, k, s, b = stem_inputs(0)
    pack = K3.pack_stem(k, s, b)
    assert pack.kscale is None
    assert torch.equal(unpack_bf16(pack), k.to(torch.bfloat16))
    assert torch.equal(pack.scale, s) and torch.equal(pack.bias, b)
    # the plain stem on the unpacked kernel is the plain stem
    got = K3.stem_conv_pool_reference(x, unpack_bf16(pack).float(),
                                      pack.scale, pack.bias)
    assert torch.equal(got, K3.stem_conv_pool_reference(x, k, s, b))


def test_stem_pack_q8_unpacks_to_codes():
    x, k, s, b = stem_inputs(1)
    pack = K3.pack_stem(k, s, b, quantize=True)
    ki, kscale = quantize_weights(k, axes=(0, 1, 2))
    codes = unpack_q8(pack)
    assert torch.equal(codes, ki)
    assert torch.equal(pack.kscale, kscale.reshape(-1))
    # the kernel's arithmetic on the unpacked codes: exact int32 sums of
    # the quantized input, one combined factor, ReLU, bf16, the pool
    x32 = x.float()
    amax = K3.abs_max(x)
    assert torch.equal(amax, x32.abs().amax().reshape(1))
    ascale = amax[0].clamp_min(1e-8) / 127.0
    acc = int8_conv_nhwc(quantize_act(x32, ascale), codes, (1, 1),
                         K3.STEM_PAD)
    y = acc.float() * (pack.scale * (ascale * pack.kscale)) + pack.bias
    got = K3.stem_pool_reference(y.clamp_min(0.0).to(torch.bfloat16))
    assert torch.equal(got, K3.stem_conv_pool_q8_reference(x, k, s, b))


@pytest.mark.parametrize('quantize', [False, True])
def test_resnet_stem_pack_rebuilt_after_weight_update(quantize):
    model = ResNet(depth=10, dtype=torch.bfloat16, quantize=quantize)
    _, k, s, b = stem_inputs(2)
    with torch.no_grad():
        model.conv1.kernel.copy_(k)
        model.bn1.scale.copy_(s)
        model.bn1.bias.copy_(b)
    pack = model.stem_pack()
    assert model.stem_pack() is pack                 # kept
    assert (pack.kscale is not None) == quantize
    with torch.no_grad():
        model.conv1.kernel.mul_(2.0)                 # in place
    fresh = model.stem_pack()
    assert fresh is not pack
    want = K3.pack_stem(model.conv1.kernel, *model.stem_affine(), quantize)
    assert torch.equal(fresh.weights, want.weights)
    with torch.no_grad():
        model.bn1.var.fill_(4.0)                     # the affine changes
    assert not torch.equal(model.stem_pack().scale, fresh.scale)
