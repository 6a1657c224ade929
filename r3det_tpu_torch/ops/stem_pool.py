"""ResNet stem: plain PyTorch forms and the CUDA kernels (K3, K3 int8, K4).

The stem runs the folded 7x7/s2 conv as a 4x4/s1 conv over the
space-to-depth(2) image (``models/resnet.py::space_to_depth_2x``), then
the folded FrozenBN affine, ReLU, and the 3x3/s2 max-pool with -inf
padding. Port of ``r3det_tpu/ops/stem_pool.py``:

- ``stem_conv_pool_reference`` (the function), and the TPU kernel
  ``stem_conv_pool_s2d4_pallas`` in both variants: bf16, and
  ``quantize=True`` (per-output-channel int8 weights, a dynamic
  per-tensor int8 input scale over the whole batch, int32 sums, one
  combined dequant x BN factor). Their CUDA counterpart is
  ``csrc/stem_pool.cu`` (K3). The same kernel serves the TPU kernels
  ``stem_conv_pool_pallas`` and ``stem_conv_pool_pallas_grouped`` (K6),
  which compute the bf16 function;
- ``stem_conv_pool_s2d4``, the unfused route (conv, then the pool), as
  :func:`stem_conv_pool_unfused`; its ``pool_kernel`` option takes the
  TPU kernel ``pool_s2d4_pallas`` (K4), here ``csrc/stem_pool.cu``'s pool
  kernel. The port has no s2d4 fold: the pool reads the plain (B, H, W, 64)
  conv output and computes the same 3x3/s2 -inf-padded max.

The s2d4 fold quantizes its (3, 3, 48, 256) kernel per output channel, and
each of its four sub-pixel groups holds all 192 taps of the (4, 4, 12, 64)
kernel, so its scales are the per-channel scales of the unfolded kernel,
which is what the port quantizes.

Layouts follow the JAX package: ``x12`` (B, H, W, 12) NHWC, ``kernel``
(4, 4, 12, 64) HWIO, ``scale``/``bias`` (64,) f32, result (B, H/2, W/2, 64)
NHWC.
"""
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _ext
from .int8_conv import int8_conv_nhwc, quantize_act, quantize_weights

CIN = 12
COUT = 64
STEM_PAD = ((2, 1), (2, 1))     # the folded conv pads 2 before, 1 after


def stem_pool_reference(y):
    """3x3/s2 max-pool with -inf padding of the conv output ``y`` (B, H, W,
    C) NHWC -> (B, H/2, W/2, C), in ``y``'s dtype."""
    h, w = y.shape[1:3]
    out = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return out[:, :, :h // 2, :w // 2].permute(0, 2, 3, 1).contiguous()


def stem_conv_pool_reference(x12, kernel, scale, bias, dtype=torch.bfloat16):
    """conv (f32 accumulation of ``dtype`` operands) + affine + ReLU,
    rounded to ``dtype``, then the -inf-padded 3x3/s2 max-pool."""
    x = x12.to(dtype).permute(0, 3, 1, 2)                    # NCHW view
    # the conv pads asymmetrically, 2 before and 1 after
    x = F.pad(x, (2, 1, 2, 1))
    k = kernel.to(dtype).permute(3, 2, 0, 1)                 # OIHW
    if dtype == torch.float32:
        y = F.conv2d(x, k)
    else:
        # bf16 operands, f32 sums: products of bf16 values are exact in
        # f32, so an f32 conv of the rounded operands is that function
        y = F.conv2d(x.float(), k.float())
    y = y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
    y = y.clamp_min(0.0).to(dtype)
    return stem_pool_reference(y.permute(0, 2, 3, 1))


def _stem_conv_q8(x12, kernel, dtype):
    """The int8 stem conv: (int32 sums (B, H, W, 64), ascale, kscale (64,)).
    ``ascale`` is max|x| over the whole batch (dynamic, on the device)."""
    x32 = x12.to(dtype).float()
    ascale = x32.abs().amax().clamp_min(1e-8) / 127.0
    ki, kscale = quantize_weights(kernel, axes=(0, 1, 2))
    acc = int8_conv_nhwc(quantize_act(x32, ascale), ki, (1, 1), STEM_PAD)
    return acc, ascale, kscale.reshape(-1)


def stem_conv_pool_q8_reference(x12, kernel, scale, bias,
                                dtype=torch.bfloat16):
    """Plain version of the int8 fused stem (K3 int8), in the kernel's
    arithmetic: ``acc * (scale * (ascale * kscale)) + bias`` with one
    combined factor, ReLU, rounded to ``dtype``, then the pool."""
    acc, ascale, kscale = _stem_conv_q8(x12, kernel, dtype)
    y = acc.float() * (scale * (ascale * kscale)) + bias
    return stem_pool_reference(y.clamp_min(0.0).to(dtype))


class StemPack(NamedTuple):
    """The K3 kernel's operands, made once per weight version by
    :func:`pack_stem`:

    - ``weights``: bf16 (4, 64, 56), ``[ky][co][kx * 12 + ci]`` (one kernel
      row is K = 48 contiguous values, as 4 pixels of 12 channels lie in an
      NHWC row), zero past 48; or, int8, the per-output-channel codes
      (4, 64, 80), ``[ky][co][kx * 16 + ci]``, zero for ci >= 12 and past
      64. The padded row strides keep the kernel's fragment loads free of
      shared-memory bank conflicts;
    - ``kscale``: the codes' (64,) f32 scales (int8), else None;
    - ``scale``, ``bias``: the folded affine, (64,) f32.
    """
    weights: torch.Tensor
    kscale: Optional[torch.Tensor]
    scale: torch.Tensor
    bias: torch.Tensor


BF16_ROW = 56      # bf16 values per packed (ky, co) row: 48 used
Q8_ROW = 80        # int8 codes per packed (ky, co) row: 4 x 16, 48 used


def pack_stem(kernel, scale, bias, quantize=False):
    """Pack the (4, 4, 12, 64) HWIO stem kernel and its folded affine for
    the K3 kernel (:class:`StemPack`), on the kernel's device."""
    if tuple(kernel.shape) != (4, 4, CIN, COUT) \
            or tuple(scale.shape) != (COUT,) or tuple(bias.shape) != (COUT,):
        raise ValueError('kernel must be (4, 4, 12, 64), scale and bias (64,)')
    kscale = None
    if quantize:
        ki, kscale = quantize_weights(kernel, axes=(0, 1, 2))
        w = F.pad(ki, (0, 0, 0, 16 - CIN)).reshape(4, 4 * 16, COUT)
        w = F.pad(w.permute(0, 2, 1), (0, Q8_ROW - 4 * 16))
        kscale = kscale.reshape(-1).float().contiguous()
    else:
        w = kernel.to(torch.bfloat16).reshape(4, 4 * CIN, COUT)
        w = F.pad(w.permute(0, 2, 1), (0, BF16_ROW - 4 * CIN))
    return StemPack(w.contiguous(), kscale, scale.float().contiguous(),
                    bias.float().contiguous())


def abs_max(x):
    """max|x| as a (1,) f32 tensor, in one read of ``x`` (no ``abs()``
    temporary); exact, so equal to ``x.abs().amax()``."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(hi, -lo).float().reshape(1)


def stem_conv_pool_cuda(x12, pack, amax=None):
    """Launch the K3 kernel (``csrc/stem_pool.cu``) on ``pack``
    (:func:`pack_stem`): bf16 in and out; an int8 ``pack`` takes the int8
    variant, which quantizes ``x12`` by ``amax`` = max|x12| ((1,) f32,
    computed here when not given)."""
    if not x12.is_cuda or x12.dtype != torch.bfloat16 or x12.dim() != 4 \
            or x12.shape[-1] != CIN or not x12.is_contiguous():
        raise ValueError(f'x12 must be a contiguous (B, H, W, {CIN}) bfloat16 '
                         f'CUDA tensor, got {x12.dtype} {tuple(x12.shape)} '
                         f'on {x12.device}')
    b, h, w, _ = x12.shape
    if h % 2 or w % 2:
        raise ValueError(f'stem input height and width must be even, got '
                         f'{h}x{w}')
    q8 = pack.kscale is not None
    shape = (4, COUT, Q8_ROW if q8 else BF16_ROW)
    if tuple(pack.weights.shape) != shape or pack.weights.dtype != (
            torch.int8 if q8 else torch.bfloat16):
        raise ValueError(f'packed stem weights must be {shape}, from '
                         f'pack_stem')
    for t in pack:
        if t is not None and (t.device != x12.device
                              or not t.is_contiguous()):
            raise ValueError('packed stem operands must be contiguous on '
                             'the input\'s device')
    if x12.data_ptr() % 16:
        raise ValueError('x12 must be 16-byte aligned')
    out = torch.empty((b, h // 2, w // 2, COUT), dtype=torch.bfloat16,
                      device=x12.device)
    stream = _ext.current_stream(x12.device)
    sms = _ext.sm_count(x12.device)
    if q8:
        # max|x| stays on the device; the kernel derives ascale from it
        amax = abs_max(x12) if amax is None else amax
        if amax.dtype != torch.float32 or amax.numel() != 1 \
                or amax.device != x12.device:
            raise ValueError('amax must be one float32 value on the '
                             'input\'s device')
        _ext.launch('stem_conv_pool_q8', x12.data_ptr(),
                    pack.weights.data_ptr(), amax.data_ptr(),
                    pack.kscale.data_ptr(), pack.scale.data_ptr(),
                    pack.bias.data_ptr(), out.data_ptr(), b, h, w, sms,
                    stream)
    else:
        _ext.launch('stem_conv_pool', x12.data_ptr(), pack.weights.data_ptr(),
                    pack.scale.data_ptr(), pack.bias.data_ptr(),
                    out.data_ptr(), b, h, w, sms, stream)
    return out


def stem_conv_pool(x12, kernel, scale, bias, dtype=torch.bfloat16,
                   quantize=False):
    """The fused stem (``quantize``: its int8 variant). CPU tensors take the
    plain form; CUDA tensors pack the weights and launch the kernel, which
    computes in bf16 only and raises for another ``dtype`` (a model packs
    once: ``ResNet.stem_pack``)."""
    if x12.is_cuda:
        if dtype != torch.bfloat16:
            raise ValueError(f'the CUDA stem kernel computes in bfloat16, '
                             f'not {dtype}')
        return stem_conv_pool_cuda(x12.to(torch.bfloat16).contiguous(),
                                   pack_stem(kernel, scale, bias, quantize))
    ref = stem_conv_pool_q8_reference if quantize else \
        stem_conv_pool_reference
    return ref(x12, kernel, scale, bias, dtype)


def stem_pool_cuda(y):
    """Launch the K4 pool kernel (``csrc/stem_pool.cu``): bf16 NHWC."""
    if not y.is_cuda or y.dtype != torch.bfloat16 or y.dim() != 4 \
            or y.shape[-1] != COUT or not y.is_contiguous():
        raise ValueError(f'y must be a contiguous (B, H, W, {COUT}) bfloat16 '
                         f'CUDA tensor, got {y.dtype} {tuple(y.shape)} on '
                         f'{y.device}')
    b, h, w, _ = y.shape
    out = torch.empty((b, h // 2, w // 2, COUT), dtype=torch.bfloat16,
                      device=y.device)
    _ext.launch('stem_pool', y.data_ptr(), out.data_ptr(), b, h, w,
                _ext.current_stream(y.device))
    return out


def stem_pool(y):
    """The stem's max-pool: the plain form on CPU tensors, the K4 kernel on
    CUDA tensors (bf16 only)."""
    return stem_pool_cuda(y) if y.is_cuda else stem_pool_reference(y)


def stem_conv_pool_unfused(x12, kernel, scale, bias, dtype=torch.bfloat16,
                           quantize=False, pool_kernel=False):
    """The stem as two passes, conv + affine + ReLU then the pool: port of
    ``stem_conv_pool_s2d4``, in its arithmetic. With ``quantize`` the int32
    sums round to bf16 in a bf16 model (the JAX route's bf16 conv output)
    and dequantize with two multiplies, ``acc * (ascale * kscale)`` then
    ``* scale + bias``. ``pool_kernel`` takes :func:`stem_pool` (K4 on a
    card) in a bf16 model, the plain pool otherwise."""
    if quantize:
        acc, ascale, kscale = _stem_conv_q8(x12, kernel, dtype)
        if dtype == torch.bfloat16:
            acc = acc.to(torch.bfloat16)
        y = acc.float() * (ascale * kscale)
    else:
        x = F.pad(x12.to(dtype).float().permute(0, 3, 1, 2), (2, 1, 2, 1))
        # dtype operands, f32 sums (exact products, as in the reference)
        y = F.conv2d(x, kernel.to(dtype).float().permute(3, 2, 0, 1))
        y = y.permute(0, 2, 3, 1)
    y = (y * scale + bias).clamp_min(0.0).to(dtype).contiguous()
    if pool_kernel and dtype == torch.bfloat16:
        return stem_pool(y)
    return stem_pool_reference(y)
