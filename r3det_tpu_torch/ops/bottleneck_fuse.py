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

The kernel reads its weights as :func:`pack_bottleneck` lays them out, once
per weight version (``models/resnet.py::Bottleneck.fused_pack`` keeps the
pack); :func:`fused_bottleneck_packed` launches on a pack.
"""
from typing import NamedTuple, Optional

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


CHUNK = 64          # bytes of K in a packed weight row


class BottleneckPack(NamedTuple):
    """The K5 kernel's operands, from :func:`pack_bottleneck`.

    - ``weights``: (bytes,) uint8, the weight stream in the order the kernel
      reads it (:func:`weight_units`);
    - ``b1``, ``b2``, ``b3``: the folded biases, f32;
    - ``s1``, ``s2``, ``s3``: q8 only, the dequant factors ``a_n * ks_n``
      (f32, per output channel), else None;
    - ``inv``: q8 only, (3,) f32 ``(1/a1, 1/a2, 1/a3)``, else None.
    """
    weights: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    b3: torch.Tensor
    s1: Optional[torch.Tensor]
    s2: Optional[torch.Tensor]
    s3: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]

    @property
    def q8(self):
        return self.inv is not None

    @property
    def features(self):
        return self.b1.numel()


def weight_rows(f, q8):
    """Rows of a weight unit (the output channels one pass of the MMAs
    makes) in the three phases of the stream for width ``f``: conv1,
    conv2 (a tap), conv3. A unit is one 64-byte K chunk of those rows."""
    return (min(f, 128) if q8 else 64), min(f, 128), 128


def _units(w, rows):
    """(N, K) weights ``[n][k]`` -> the bytes of their units: for each
    block of ``rows`` output channels, for each 64-byte chunk of K, a
    (rows, 64 bytes) tile whose 16-byte pieces are swizzled as Hopper's
    64-byte K-major layout reads them (piece c of row n stored at c ^ ((n
    >> 1) & 3))."""
    n, k = w.shape
    per = 16 // w.element_size()              # elements a 16-byte piece
    kc = CHUNK // w.element_size()
    u = w.reshape(n // rows, rows, k // kc, 4, per).permute(0, 2, 1, 3, 4)
    r = torch.arange(rows, device=w.device)[:, None]
    piece = torch.arange(4, device=w.device)[None] ^ ((r >> 1) & 3)
    return u[:, :, r, piece].contiguous().view(torch.uint8).reshape(-1)


def weight_units(w1, w2, w3):
    """The kernel's weight stream from (N, K) ``[n][k]`` weights w1 (F, 4F),
    w2 (9, F, F) per tap, w3 (4F, F), bf16 or int8 codes, pass by pass:
    conv1's K chunks, conv2's taps (each tap's K chunks), conv3's K
    chunks."""
    f = w1.shape[0]
    r1, r2, r3 = weight_rows(f, w1.dtype == torch.int8)
    conv2 = [_units(w2[t, n:n + r2], r2) for n in range(0, f, r2)
             for t in range(9)]
    return torch.cat([_units(w1, r1)] + conv2 + [_units(w3, r3)])


def pack_bottleneck(w1, b1, w2, b2, w3, b3, amax1=None, amax2=None,
                    amax3=None):
    """Pack a BN-folded bottleneck (HWIO f32 weights, f32 biases) for the
    K5 kernel, on the weights' device: bf16 weights, or with the three
    calibrated ranges ``amax*`` the int8 codes of :func:`_wq` and the
    scales of :func:`fused_bottleneck_q8_reference`."""
    c4, f = w1.shape[-2], w1.shape[-1]
    if f not in FEATURES or c4 != 4 * f or tuple(w2.shape) != (3, 3, f, f) \
            or tuple(w3.shape[-2:]) != (f, c4):
        raise ValueError(f'the bottleneck kernel takes F in {FEATURES} and '
                         f'C = 4F; got w1 {tuple(w1.shape)}, w2 '
                         f'{tuple(w2.shape)}, w3 {tuple(w3.shape)}')
    w1, w2, w3 = w1.reshape(c4, f), w2.reshape(9, f, f), w3.reshape(f, c4)
    b1, b2, b3 = _f32(b1, b2, b3)
    if amax1 is None:
        bf = torch.bfloat16
        stream = weight_units(w1.t().to(bf), w2.transpose(1, 2).to(bf),
                              w3.t().to(bf))
        return BottleneckPack(stream, b1, b2, b3, None, None, None, None)
    w1i, ks1 = _wq(w1)
    w2i, ks2 = _wq(w2)
    w3i, ks3 = _wq(w3)
    a1, a2, a3 = _act_scales(amax1, amax2, amax3)
    inv = torch.stack([1.0 / a1, 1.0 / a2, 1.0 / a3]).to(w1.device)
    s1, s2, s3 = _f32(a1 * ks1, a2 * ks2, a3 * ks3)
    stream = weight_units(w1i.t(), w2i.transpose(1, 2), w3i.t())
    return BottleneckPack(stream, b1, b2, b3, s1, s2, s3, inv)


def _f32(*ts):
    return [t.to(torch.float32).reshape(-1).contiguous() for t in ts]


def fused_bottleneck_packed(x, pack):
    """Launch the K5 kernel (``csrc/bottleneck.cu``) on ``pack``
    (:func:`pack_bottleneck`): bf16, or int8 for a q8 pack. Raises on
    inputs the kernel does not take."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f'x must be a contiguous, 16-byte aligned NHWC '
                         f'bfloat16 CUDA tensor, got {x.dtype} '
                         f'{tuple(x.shape)} on {x.device}')
    b, h, w, c4 = x.shape
    f = pack.features
    if f not in FEATURES or c4 != 4 * f or h % BTL_TH:
        raise ValueError(f'the bottleneck kernel takes F in {FEATURES}, '
                         f'C = 4F and H % {BTL_TH} == 0; got F={f}, '
                         f'x {tuple(x.shape)}')
    nbytes = (4 + 9 + 4) * f * f * (1 if pack.q8 else 2)
    if pack.weights.dtype != torch.uint8 or pack.weights.numel() != nbytes:
        raise ValueError(f'the pack holds {pack.weights.numel()} weight '
                         f'bytes, F={f} needs {nbytes}: use pack_bottleneck')
    for t in pack:
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError('the pack must lie, contiguous, on the input\'s '
                             'device')
    out = torch.empty_like(x)
    args = (b, h, w, f, _ext.sm_count(x.device), _ext.current_stream(x.device))
    if pack.q8:
        _ext.launch('bottleneck_q8', x.data_ptr(), pack.inv.data_ptr(),
                    pack.weights.data_ptr(), pack.s1.data_ptr(),
                    pack.b1.data_ptr(), pack.s2.data_ptr(),
                    pack.b2.data_ptr(), pack.s3.data_ptr(),
                    pack.b3.data_ptr(), out.data_ptr(), *args)
    else:
        _ext.launch('bottleneck', x.data_ptr(), pack.weights.data_ptr(),
                    pack.b1.data_ptr(), pack.b2.data_ptr(),
                    pack.b3.data_ptr(), out.data_ptr(), *args)
    return out


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """The bf16 K5 kernel on weights packed in the call (callers that keep
    weights across calls keep the pack: :func:`fused_bottleneck_packed`)."""
    return fused_bottleneck_packed(x, pack_bottleneck(w1, b1, w2, b2, w3, b3))


def fused_bottleneck_q8_cuda(x, w1, b1, w2, b2, w3, b3, amax1, amax2, amax3):
    """The int8 K5 kernel on weights packed in the call."""
    return fused_bottleneck_packed(x, pack_bottleneck(
        w1, b1, w2, b2, w3, b3, amax1, amax2, amax3))


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
