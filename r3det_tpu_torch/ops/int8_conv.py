"""Exact int8 x int8 -> int32 convolution, the symmetric int8 grids, and
``QConv``'s quantized convolution with its CUDA kernel.

The JAX package computes its int8 convolutions with
``lax.conv_general_dilated(..., preferred_element_type=int32 | bf16)``,
outside any Pallas kernel, and leaves them to XLA. PyTorch has no int8
convolution on CUDA, so the plain form here is an int8 im2col feeding
``torch._int_mm`` ((M, K) x (K, N) int8 -> int32; cuBLASLt on the card,
exact on the CPU); a 1x1 stride-1 convolution needs no im2col: its NHWC
rows are the matrix. :func:`qconv_reference` is the whole quantized
convolution of ``QConv`` (quantize, int8 product, dequant);
:func:`qconv_fused` adds the ops that follow it in the serving path
(FrozenBN, residual, ReLU, the next conv's quantize). Where its contract
:func:`refusal` holds (``ops/route.py``) either is one launch of the hand
kernel ``csrc/int8_conv.cu`` (:func:`qconv_cuda`), whose weights
:func:`pack_weights` lays out once per weight version (``QConv.packed``).

The quantization helpers keep the JAX package's arithmetic: per-output-
channel weight scales ``max(max|w|, 1e-8) / 127``, codes
``clip(round(w / s), -127, 127)`` with round half to even (``torch.round``
and ``jnp.round`` agree).
"""
import torch
import torch.nn.functional as F

from .. import _ext
from . import route

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
    """QConv's quantized convolution, plain form: ``x`` NHWC (quantized
    here by ``ascale``) or int8 NHWC codes; ``wi`` HWIO int8, ``kscale`` (Co,);
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


def pack_weights(wi):
    """The int8 conv kernel's weight layout: HWIO codes (kh, kw, Ci, Co) ->
    (Co / bn, Ci / ck, kh, kw, bn, ck) int8, where bn = 256 output
    channels (128 or 64 when Co is not a multiple of 256 or 128) and ck =
    64 input channels (32 when Ci is not a multiple of 64). Each (bn,
    chunk, tap) slice is a shared-memory weight stage as the kernel's MMA
    reads it, so it arrives in one bulk copy: one ck-byte row per output
    channel n, its 16-byte pieces swizzled (piece c stored at c ^ ((n >> 1)
    & 3) for ck = 64, c ^ ((n >> 2) & 1) for ck = 32: Hopper's 64- and
    32-byte swizzled K-major layouts)."""
    kh, kw, ci, co = wi.shape
    bn = next((n for n in (256, 128, 64) if co % n == 0), None)
    ck = 64 if ci % 64 == 0 else 32
    if bn is None or ci % ck:
        raise ValueError(f'the int8 conv kernel takes Ci % 32 == 0 and '
                         f'Co % 64 == 0, got {ci} -> {co}')
    w = wi.reshape(kh, kw, ci // ck, ck // 16, 16, co // bn, bn)
    w = w.permute(5, 2, 0, 1, 6, 3, 4)       # (nb, nc, kh, kw, bn, c16, 16)
    n = torch.arange(bn, device=wi.device)[:, None]
    swz = (n >> 1) & 3 if ck == 64 else (n >> 2) & 1
    piece = torch.arange(ck // 16, device=wi.device)[None] ^ swz
    w = w[:, :, :, :, n, piece]                # position c holds c ^ swz
    return w.reshape(co // bn, ci // ck, kh, kw, bn, ck).contiguous()


def _scalar(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def refusal(x, dtype, ci, co, *needs):
    """The kernel's contract (``ops/route.py``): a ``ci`` -> ``co`` conv,
    Ci % 32 == 0 and Co % 64 == 0, of NHWC bf16 or int8 ``x``, to bf16."""
    if ci % 32 or co % 64:
        return f'the kernel takes Ci % 32 == Co % 64 == 0, not {ci} -> {co}'
    if x.dtype not in (torch.bfloat16, torch.int8):
        return f'the kernel reads bfloat16 or int8, not {x.dtype}'
    return route.refusal(x, dtype, x, *needs)


def qconv_cuda(x, ascale, packed, kscale, bias, stride, padding, *,
               affine=None, residual=None, relu=False, out_scale=None):
    """Launch the int8 conv kernel (``csrc/int8_conv.cu``) with
    ``pack_weights``' layout; see :func:`qconv_fused` for the epilogue.
    Returns bf16 NHWC, or ``(int8 codes, out_scale)`` when ``out_scale``
    is given."""
    _check(packed.dim() == 6 and packed.dtype == torch.int8
           and packed.is_contiguous() and packed.device == x.device,
           'packed must be pack_weights\' int8 layout on the input\'s '
           'device')
    nb, nc, kh, kw, bn, ck = packed.shape
    co = nb * bn
    route.check(refusal(x, torch.bfloat16, nc * ck, co), 'int8_conv')
    _check(x.dim() == 4 and x.is_contiguous(),
           f'x must be a contiguous NHWC tensor, got {tuple(x.shape)}')
    b, h, w, ci = x.shape
    _check(ci == nc * ck, f'input has {ci} channels, weights {nc * ck}')
    (sh, sw), (ph, pw) = stride, padding
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    dev = x.device

    def channels(t, dtype):
        return (t.dtype == dtype and t.shape == (co,) and t.is_contiguous()
                and t.device == dev)
    kscale = kscale.reshape(-1)
    _check(channels(kscale, torch.float32), 'kscale must be (Co,) float32 '
                                            'on the input\'s device')
    _check(bias is None or channels(bias, torch.float32),
           'bias must be (Co,) float32 on the input\'s device')
    inv = bnb = res = rscale = oscale = None
    res_kind = 0
    if affine is not None:
        inv, bnb = affine
        _check(channels(inv, torch.bfloat16) and channels(bnb, torch.bfloat16),
               'affine must be two (Co,) bfloat16 tensors on the input\'s '
               'device')
    if residual is not None:
        if isinstance(residual, tuple):
            res, rscale = residual
            rscale = _scalar(rscale, dev)
            res_kind = 2
            _check(res.dtype == torch.int8, 'residual codes must be int8')
        else:
            res, res_kind = residual, 1
            _check(res.dtype == torch.bfloat16,
                   'a float residual must be bfloat16')
        _check(res.device == dev and res.shape == (b, ho, wo, co)
               and res.is_contiguous(),
               f'residual must be a contiguous {(b, ho, wo, co)} tensor on '
               f'the input\'s device')
    if out_scale is not None:
        oscale = _scalar(out_scale, dev)
    ascale = _scalar(ascale, dev)
    out = torch.empty((b, ho, wo, co), device=dev,
                      dtype=torch.bfloat16 if oscale is None else torch.int8)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _ext.launch('int8_conv', x.data_ptr(), int(x.dtype != torch.int8),
                ascale.data_ptr(), packed.data_ptr(), bn, ck,
                kscale.data_ptr(), ptr(bias), ptr(inv), ptr(bnb), ptr(res),
                res_kind, ptr(rscale), int(bool(relu)), out.data_ptr(),
                int(oscale is not None), ptr(oscale), b, h, w, ci, ho, wo, co,
                kh, kw, sh, sw, ph, pw, _ext.current_stream(dev))
    return out if oscale is None else (out, out_scale)


def qconv_fused_reference(x, ascale, wi, kscale, bias, stride, padding, *,
                          affine=None, residual=None, relu=False,
                          out_scale=None):
    """Plain version of :func:`qconv_fused`: :func:`qconv_reference` in
    bf16, then the PyTorch ops of the unfused modules in their order:
    FrozenBN's ``y * inv + b``, the residual add (int8 codes dequantized
    to bf16 first, as ``Bottleneck.int8_act`` does), ReLU, and the next
    static ``QConv``'s :func:`quantize_act`."""
    y = qconv_reference(x, ascale, wi, kscale, bias, stride, padding,
                        torch.bfloat16)
    if affine is not None:
        inv, b = affine
        y = y * inv + b
    if residual is not None:
        if isinstance(residual, tuple):
            codes, rscale = residual
            residual = (codes.float() * rscale).to(torch.bfloat16)
        y = y + residual
    if relu:
        y = F.relu(y)
    if out_scale is not None:
        return quantize_act(y, out_scale), out_scale
    return y


def qconv_fused(x, ascale, wi, kscale, bias, stride, padding, *, affine=None,
                residual=None, relu=False, out_scale=None, packed=None):
    """The quantized convolution with the ops that follow it in a bf16
    int8-static model, in one launch on a card:

    - ``x``: NHWC bf16 (quantized by ``ascale``) or int8 codes;
    - ``affine``: FrozenBN's ``(inv, b)``, (Co,) bf16 each;
    - ``residual``: NHWC bf16, or ``(int8 codes, rscale)``;
    - ``relu``; ``out_scale``: return ``(int8 codes, out_scale)`` of the
      result (the next static ``QConv``'s input) instead of bf16.

    The kernel where :func:`refusal` holds, the plain form
    (:func:`qconv_fused_reference`) otherwise."""
    kw = dict(affine=affine, residual=residual, relu=relu,
              out_scale=out_scale)
    if refusal(x, torch.bfloat16, *wi.shape[2:], wi, kscale, bias) is None:
        return qconv_cuda(x.contiguous(), ascale,
                          pack_weights(wi) if packed is None else packed,
                          kscale, bias, stride, padding, **kw)
    return qconv_fused_reference(x, ascale, wi, kscale, bias, stride,
                                 padding, **kw)
