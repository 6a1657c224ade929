"""The kernels' contracts (``ops/route.py``) and the stem kernel's weight
pack, on the CPU.

- Each kernel's contract takes the kernel only with the switch on, for
  inputs on a card, in the dtype the kernel computes in and, for a kernel
  that has no backward (all but K2), with no gradient to carry: so an f32
  model, a CPU tensor and a call under autograd take the plain form. The
  inputs' device, dtype and gradient are given here as flags.
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

from r3det_tpu_torch.models.resnet import ResNet
from r3det_tpu_torch.ops import bottleneck_fuse as K5
from r3det_tpu_torch.ops import conv_epilogue as E
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.ops import int8_conv as Q
from r3det_tpu_torch.ops import rotated_iou as K1
from r3det_tpu_torch.ops import stem_pool as K3
from r3det_tpu_torch.ops import lsk_attn as L
from r3det_tpu_torch.ops import lsk_mlp as M
from r3det_tpu_torch.ops import swin_attn as A
from r3det_tpu_torch.ops.int8_conv import (int8_conv_nhwc, quantize_act,
                                           quantize_weights)
from r3det_tpu_torch.ops.route import kernels, kernels_on

torch.set_num_threads(2)
BF16 = torch.bfloat16


def flags(shape, dtype, is_cuda, grad):
    """What a contract reads of a tensor: its shape, dtype, device and
    whether it requires a gradient."""
    return types.SimpleNamespace(
        shape=shape, dtype=dtype, is_cuda=is_cuda, requires_grad=grad,
        device=torch.device('cuda' if is_cuda else 'cpu'))


def channels_last(x):
    """``flags`` of a map held channels_last."""
    x.is_contiguous = lambda memory_format=None: True
    return x


# kernel -> (the dtype it computes in, whether it has a backward, a shape
# it takes, its contract on an input of that shape)
CONTRACTS = {
    'K1': (torch.float32, False, (1, 8, 5), lambda x: K1.refusal(x, x)),
    'K2': (BF16, True, (2, 8, 8, 32), lambda x: K2.refusal([x, x])),
    'K3': (BF16, False, (2, 8, 8, 12),
           lambda x: K3.stem_refusal(x, x.dtype)),
    'K4': (BF16, False, (2, 8, 8, 64), K3.pool_refusal),
    'K5': (BF16, False, (2, 8, 8, 256), lambda x: K5.refusal(x, 64)),
    'int8_conv': (BF16, False, (2, 8, 8, 64),
                  lambda x: Q.refusal(x, x.dtype, 64, 64)),
    'conv_epilogue': (BF16, False, (2, 64, 8, 8), E.refusal),
    'swin_norm_pad': (BF16, False, (2, 7, 7, 96), A.norm_pad_refusal),
    'swin_window_attn': (BF16, False, (2, 7, 7, 288),
                         lambda x: A.window_attn_refusal(x, 3, 7)),
    'swin_sub_block': (BF16, False, (2, 7, 7, 96),
                       lambda x: A.refusal(x, 3, 7)),
    'lsk_taps': (BF16, False, (2, 8, 8, 64), L.taps_refusal),
    'lsk_select': (BF16, False, (2, 8, 8, 64), L.select_refusal),
    'lsk_epilogue': (BF16, False, (2, 8, 8, 64), L.epilogue_refusal),
    'lsk_sub_block': (BF16, False, (2, 64, 8, 8),
                      lambda x: L.refusal(channels_last(x))),
    'lsk_dw_gelu': (BF16, False, (2, 8, 8, 256), M.dw_gelu_refusal),
    'lsk_mlp_sub_block': (BF16, False, (2, 64, 8, 8),
                          lambda x: M.refusal(channels_last(x), 256)),
}


@pytest.mark.parametrize('grad', [False, True], ids=['no_grad', 'grad'])
@pytest.mark.parametrize('dtype', [BF16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('cuda', [True, False], ids=['card', 'cpu'])
@pytest.mark.parametrize('kernel', list(CONTRACTS))
def test_contract_takes_the_kernel_only_as_specified(kernel, cuda, dtype,
                                                     grad):
    """Switch on: the kernel on a card in its dtype, and under autograd
    only if it has a backward. Switch off: never, with a reason."""
    want, backward, shape, contract = CONTRACTS[kernel]
    x = flags(shape, dtype, cuda, grad)
    with torch.set_grad_enabled(grad):
        why = contract(x)
        assert (why is None) == (cuda and dtype == want
                                 and (backward or not grad)), why
        assert why is None or isinstance(why, str)
        with kernels(False):
            assert 'switched off' in (contract(flags(shape, want, True,
                                                     False)) or '')


def test_switch_nests_and_restores():
    """``kernels(False)`` holds inside it, ``kernels(True)`` turns nothing
    back on, and each block restores what it found."""
    assert kernels_on()
    with kernels(True):
        assert kernels_on()
        with kernels(False):
            assert not kernels_on()
            with kernels(True):
                assert not kernels_on()
            assert not kernels_on()
        assert kernels_on()
    assert kernels_on()


# kernel, an input shape it does not take, the words of the reason
SHAPE_REFUSALS = {
    'K2_channels': ('K2', (2, 8, 8, 12), 'C % 8'),
    'K3_odd_side': ('K3', (2, 9, 8, 12), 'even'),
    'K4_channels': ('K4', (2, 8, 8, 32), '64 channels'),
    'K5_height': ('K5', (2, 12, 8, 256), 'H %'),
    'K5_channels': ('K5', (2, 8, 8, 128), 'C = 4F'),
    'conv_epilogue_channels': ('conv_epilogue', (2, 72, 8, 8), 'C % 64'),
    'swin_norm_pad_width': ('swin_norm_pad', (2, 7, 7, 1024), 'up to'),
    'swin_window_attn_head_dim': ('swin_window_attn', (2, 7, 7, 576),
                                  'head_dim'),
    'lsk_dw_gelu_channels': ('lsk_dw_gelu', (2, 8, 8, 260), 'C % 8'),
}


@pytest.mark.parametrize('case', list(SHAPE_REFUSALS))
def test_contract_refuses_shapes_the_kernel_cannot_do(case):
    kernel, shape, words = SHAPE_REFUSALS[case]
    want, _, _, contract = CONTRACTS[kernel]
    with torch.no_grad():
        assert words in (contract(flags(shape, want, True, False)) or '')


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
