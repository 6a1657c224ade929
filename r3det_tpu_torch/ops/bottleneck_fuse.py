"""Fused stride-1 identity ResNet bottleneck: plain PyTorch forms and the
CUDA kernels (K5, bf16 and int8).

Port of ``r3det_tpu/ops/bottleneck_fuse.py``: ``fold_bn`` and ``_wq``, the
TPU kernels ``fused_bottleneck`` and ``fused_bottleneck_q8``, and their
plain forms (``models/resnet.py::Bottleneck``'s ``xla_ref`` and
``fused_bottleneck_q8_xla``). The CUDA counterpart of both kernels is
``csrc/bottleneck.cu``.

The function: ``relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + x)``
with FrozenBN folded into the convs (1x1, 3x3 with zero padding, 1x1).

- bf16: bf16 data and weights, f32 sums; each intermediate is rounded to
  bf16 after its bias and ReLU.
- int8: each conv input is quantized with its calibrated static scale by
  the reciprocal multiply ``clip(round(v * (1 / a)))`` (not ``QConv``'s
  divide: the two round differently at .5 boundaries), the BN-folded
  weights per output channel (``_wq``), the sums are exact int32, and each
  dequant factor ``a * ks`` is multiplied out before use. The
  intermediates stay f32 between the convs.

Layouts follow the JAX package: ``x`` (B, H, W, 4F) NHWC bf16; ``w1``
(1, 1, 4F, F), ``w2`` (3, 3, F, F), ``w3`` (1, 1, F, 4F) HWIO, BN-folded f32;
``b*`` f32; ``amax*`` calibrated absmax scalars.
"""
import torch
import torch.nn.functional as F

from .. import _ext
from .int8_conv import int8_conv_nhwc, quantize_weights

BTL_TH = 8                      # the gate's row multiple (H % 8 == 0)
FEATURES = (64, 128, 256)       # bottleneck widths the CUDA kernel takes


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold FrozenBN into HWIO conv weights exactly: conv(x, k) * inv + off
    == conv(x, k * inv) + off."""
    inv = scale * torch.rsqrt(var + eps)
    off = bias - mean * inv
    return kernel * inv, off


def _wq(w):
    """Per-output-channel (last axis) symmetric int8 codes and (co,) f32
    scale of the BN-folded kernel."""
    wi, s = quantize_weights(w, axes=tuple(range(w.dim() - 1)))
    return wi, s.reshape(-1)


def _q8(v, inv):
    return torch.clamp(torch.round(v * inv), -127.0, 127.0).to(torch.int8)


def _act_scales(amax1, amax2, amax3):
    return [torch.as_tensor(a, dtype=torch.float32).clamp_min(1e-8) / 127.0
            for a in (amax1, amax2, amax3)]


def _conv_f32(v, w, pad):
    """NHWC ``v`` x HWIO ``w``, both bf16-valued, f32 sums (products of bf16
    values are exact in f32)."""
    y = F.conv2d(v.float().permute(0, 3, 1, 2),
                 w.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain version of the bf16 fused bottleneck (``xla_ref``)."""
    x = x.to(torch.bfloat16)
    y = (_conv_f32(x, w1, 0) + b1).clamp_min(0.0).to(torch.bfloat16)
    y = (_conv_f32(y, w2, 1) + b2).clamp_min(0.0).to(torch.bfloat16)
    y = _conv_f32(y, w3, 0) + b3
    return (y + x.float()).clamp_min(0.0).to(torch.bfloat16)


def fused_bottleneck_q8_reference(x, w1, b1, w2, b2, w3, b3, amax1, amax2,
                                  amax3):
    """Plain version of the int8 fused bottleneck
    (``fused_bottleneck_q8_xla``): the kernel's quantization grids."""
    w1i, ks1 = _wq(w1)
    w2i, ks2 = _wq(w2)
    w3i, ks3 = _wq(w3)
    a1, a2, a3 = _act_scales(amax1, amax2, amax3)
    xf = x.to(torch.bfloat16).float()
    y = int8_conv_nhwc(_q8(xf, 1.0 / a1), w1i).float()
    y = (y * (a1 * ks1) + b1).clamp_min(0.0)
    y = int8_conv_nhwc(_q8(y, 1.0 / a2), w2i, padding=((1, 1), (1, 1)))
    y = (y.float() * (a2 * ks2) + b2).clamp_min(0.0)
    y = int8_conv_nhwc(_q8(y, 1.0 / a3), w3i).float()
    y = y * (a3 * ks3) + b3
    return (y + xf).clamp_min(0.0).to(torch.bfloat16)


def _check(x, w1):
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4 \
            or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous NHWC bfloat16 CUDA tensor, '
                         f'got {x.dtype} {tuple(x.shape)} on {x.device}')
    b, h, w, c4 = x.shape
    f = w1.shape[-1]
    if f not in FEATURES or c4 != 4 * f or h % BTL_TH:
        raise ValueError(f'the bottleneck kernel takes F in {FEATURES}, '
                         f'C = 4F and H % {BTL_TH} == 0; got F={f}, '
                         f'x {tuple(x.shape)}')
    return b, h, w, c4, f


def _f32(*ts):
    return [t.to(torch.float32).reshape(-1).contiguous() for t in ts]


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch the bf16 K5 kernel (``csrc/bottleneck.cu``). Weights go over
    as [n][k] (K contiguous) bf16: w1 (F, 4F), w2 (9, F, F), w3 (4F, F)."""
    b, h, w, c4, f = _check(x, w1)
    bf = torch.bfloat16
    w1p = w1.reshape(c4, f).t().to(bf).contiguous()
    w2p = w2.reshape(9, f, f).transpose(1, 2).to(bf).contiguous()
    w3p = w3.reshape(f, c4).t().to(bf).contiguous()
    b1, b2, b3 = _f32(b1, b2, b3)
    out = torch.empty_like(x)
    _ext.launch('bottleneck', x.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                w2p.data_ptr(), b2.data_ptr(), w3p.data_ptr(), b3.data_ptr(),
                out.data_ptr(), b, h, w, f, _ext.current_stream(x.device))
    return out


def fused_bottleneck_q8_cuda(x, w1, b1, w2, b2, w3, b3, amax1, amax2, amax3):
    """Launch the int8 K5 kernel (``csrc/bottleneck.cu``). The scales stay
    on the device: ``inv`` = (1/a1, 1/a2, 1/a3) and the per-channel
    dequant factors ``s_n = a_n * ks_n`` go over by pointer."""
    b, h, w, c4, f = _check(x, w1)
    w1i, ks1 = _wq(w1.reshape(c4, f))
    w2i, ks2 = _wq(w2.reshape(9, f, f))
    w3i, ks3 = _wq(w3.reshape(f, c4))
    a1, a2, a3 = _act_scales(amax1, amax2, amax3)
    inv = torch.stack([1.0 / a1, 1.0 / a2, 1.0 / a3]).to(x.device)
    s1, s2, s3 = _f32(a1 * ks1, a2 * ks2, a3 * ks3)
    b1, b2, b3 = _f32(b1, b2, b3)
    w1p = w1i.t().contiguous()
    w2p = w2i.transpose(1, 2).contiguous()
    w3p = w3i.t().contiguous()
    out = torch.empty_like(x)
    _ext.launch('bottleneck_q8', x.data_ptr(), inv.data_ptr(),
                w1p.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                w2p.data_ptr(), s2.data_ptr(), b2.data_ptr(),
                w3p.data_ptr(), s3.data_ptr(), b3.data_ptr(),
                out.data_ptr(), b, h, w, f, _ext.current_stream(x.device))
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """The bf16 fused bottleneck: plain form on CPU tensors, the kernel on
    CUDA tensors."""
    fn = fused_bottleneck_cuda if x.is_cuda else fused_bottleneck_reference
    return fn(x, w1, b1, w2, b2, w3, b3)


def fused_bottleneck_q8(x, w1, b1, w2, b2, w3, b3, amax1, amax2, amax3):
    """The int8 fused bottleneck: plain form on CPU tensors, the kernel on
    CUDA tensors."""
    fn = fused_bottleneck_q8_cuda if x.is_cuda else \
        fused_bottleneck_q8_reference
    return fn(x, w1, b1, w2, b2, w3, b3, amax1, amax2, amax3)
