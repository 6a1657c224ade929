"""Exact int8 x int8 -> int32 convolution, the symmetric int8 grids, and
``QConv``'s quantized convolution with its CUDA kernel.

The JAX package computes its int8 convolutions with
``lax.conv_general_dilated(..., preferred_element_type=int32 | bf16)``,
outside any Pallas kernel, and leaves them to XLA. PyTorch has no int8
convolution on CUDA, so the plain form here is an int8 im2col feeding
``torch._int_mm`` ((M, K) x (K, N) int8 -> int32; cuBLASLt on the card,
exact on the CPU); a 1x1 stride-1 convolution needs no im2col: its NHWC
rows are the matrix. :func:`qconv` is the whole quantized convolution of
``QConv`` (quantize, int8 product, dequant); on a card in a bf16 model it
runs as one hand kernel, ``csrc/int8_conv.cu``.

The quantization helpers keep the JAX package's arithmetic: per-output-
channel weight scales ``max(max|w|, 1e-8) / 127``, codes
``clip(round(w / s), -127, 127)`` with round half to even (``torch.round``
and ``jnp.round`` agree).
"""
import torch
import torch.nn.functional as F

from .. import _ext

# torch._int_mm needs M > 16 and K, N multiples of 8
_MIN_M = 17


def quantize_weights(w, axes):
    """Symmetric per-channel int8 codes of the f32 tensor ``w``: the scale
    is taken over ``axes`` (every axis but the output channel's). Returns
    ``(int8 codes, f32 scale)`` with the scale shaped for broadcasting."""
    w = w.float()
    scale = w.abs().amax(dim=axes, keepdim=True).clamp_min(1e-8) / 127.0
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_act(x, ascale):
    """Per-tensor int8 codes ``clip(round(x / ascale), -127, 127)``."""
    return torch.clamp(torch.round(x.float() / ascale), -127,
                       127).to(torch.int8)


def _pad_to(n, m):
    return -(-n // m) * m


def int_matmul(a, b):
    """(M, K) int8 x (K, N) int8 -> exact (M, N) int32 through
    ``torch._int_mm``; pads M, K and N to what it takes."""
    m, k = a.shape
    n = b.shape[1]
    kp, np_, mp = _pad_to(k, 8), _pad_to(n, 8), max(m, _MIN_M)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    # row-major A and column-major B: the layout cuBLASLt's int8 GEMM takes
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def int8_conv_nhwc(xi, wi, stride=(1, 1), padding=((0, 0), (0, 0))):
    """int8 convolution: ``xi`` (B, H, W, Ci) int8 NHWC, ``wi`` (kh, kw, Ci,
    Co) int8 HWIO, ``padding`` ((top, bottom), (left, right)) of zeros ->
    (B, Ho, Wo, Co) int32, exact."""
    kh, kw, ci, co = wi.shape
    sh, sw = stride
    (pt, pb), (pl, pr) = padding
    if pt or pb or pl or pr:
        xi = F.pad(xi, (0, 0, pl, pr, pt, pb))
    b, h, w, _ = xi.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    if kh == kw == 1:
        cols = xi[:, :sh * (ho - 1) + 1:sh, :sw * (wo - 1) + 1:sw]
        cols = cols.reshape(b * ho * wo, ci)
    else:
        # im2col in (ky, kx, ci) order, the order of the HWIO reshape
        cols = torch.stack(
            [xi[:, ky:ky + sh * (ho - 1) + 1:sh, kx:kx + sw * (wo - 1) + 1:sw]
             for ky in range(kh) for kx in range(kw)], 3)
        cols = cols.reshape(b * ho * wo, kh * kw * ci)
    out = int_matmul(cols, wi.reshape(kh * kw * ci, co))
    return out.reshape(b, ho, wo, co)


def qconv_reference(x, ascale, wi, kscale, bias, stride, padding, dtype):
    """Plain version of :func:`qconv`: ``x`` NHWC (quantized here by
    ``ascale``) or int8 NHWC codes; ``wi`` HWIO int8, ``kscale`` (Co,);
    ``padding`` (ph, pw) symmetric. Returns NHWC in ``dtype``: the int32
    sums, rounded to bf16 in a bf16 model, times ``ascale * kscale``, plus
    ``bias``."""
    xi = x if x.dtype == torch.int8 else quantize_act(x, ascale)
    ph, pw = padding
    y = int8_conv_nhwc(xi, wi, stride, ((ph, ph), (pw, pw)))
    if dtype == torch.bfloat16:
        y = y.to(torch.bfloat16)
    y = y.float() * (ascale * kscale)
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def qconv_cuda(x, ascale, wi, kscale, bias, stride, padding):
    """Launch the int8 conv kernel (``csrc/int8_conv.cu``): bf16 out."""
    if not x.is_cuda or x.dim() != 4 or not x.is_contiguous() \
            or x.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f'x must be a contiguous NHWC bfloat16 or int8 CUDA '
                         f'tensor, got {x.dtype} {tuple(x.shape)} on '
                         f'{x.device}')
    b, h, w, ci = x.shape
    kh, kw, _, co = wi.shape
    if ci % 32 or co % 64 or (ci > 128 and ci % 128):
        raise ValueError(f'the int8 conv kernel takes Ci % 32 == 0 (and '
                         f'% 128 above 128) and Co % 64 == 0, got {ci} -> '
                         f'{co}')
    (sh, sw), (ph, pw) = stride, padding
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    ascale = torch.as_tensor(ascale, dtype=torch.float32,
                             device=x.device).reshape(1)
    wpack = wi.permute(3, 0, 1, 2).contiguous()        # (Co, kh, kw, Ci)
    kscale = kscale.float().reshape(-1).contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16,
                      device=x.device)
    _ext.launch('int8_conv', x.data_ptr(), int(x.dtype != torch.int8),
                ascale.data_ptr(), wpack.data_ptr(), kscale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                b, h, w, ci, ho, wo, co, kh, kw, sh, sw, ph, pw,
                _ext.current_stream(x.device))
    return out


def qconv(x, ascale, wi, kscale, bias, stride, padding, dtype):
    """The quantized convolution: the plain form on CPU tensors; the kernel
    on CUDA tensors, which computes in bf16 only and raises otherwise."""
    if x.is_cuda:
        if dtype != torch.bfloat16:
            raise ValueError(f'the CUDA int8 conv kernel writes bfloat16, '
                             f'not {dtype}')
        return qconv_cuda(x.contiguous(), ascale, wi, kscale, bias, stride,
                          padding)
    return qconv_reference(x, ascale, wi, kscale, bias, stride, padding,
                           dtype)
