"""LSKNet's MLP sub-block on the bf16 serving path: plain PyTorch forms and
the CUDA kernels (``csrc/lsk_attn.cu``).

``models/lsknet.py::Block`` runs ``x + layer_scale_2 * fc2(GELU(dwconv(
fc1(norm2(x)))))`` through :func:`mlp` where :func:`refusal` holds: two
products on the NHWC view (``F.linear``: cuBLAS, no bias) around two
passes, channels_last, no layout copy. The hidden map is written once by
fc1's product and read once by :func:`dw_gelu`, which writes it once for
fc2's product to read once:

1. ``fc1``'s product of ``x``, ``norm2`` folded into its weight and bias
   (:func:`pack`); the fold is exact in meaning, since fc1 is 1x1 and
   ``dwconv`` pads fc1's output, not its input;
2. :func:`dw_gelu`: fc1's bias (zero outside the map, as ``dwconv`` pads
   fc1's output), the 3x3 depthwise taps and their bias and exact GELU,
   all in float32, rounded once;
3. ``fc2``'s product, then :func:`bias_scale`: its bias and ``x +
   layer_scale_2 * (.)``, in place (``lsk_attn.py``'s epilogue template).

Each pass has a contract (``*_refusal``), a plain form (``*_reference``,
which repeats the kernel's arithmetic and roundings and is what the kernel
is held to; in float32 on the CPU it is the eager module's ops), a
``*_cuda`` wrapper that raises where the contract does not hold, and a
public entry that takes the kernel where it holds and the plain form
otherwise. Maps are (B, H, W, channels). The JAX package has no LSKNet,
so no TPU kernel stands behind either.
"""
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _ext
from . import route
from .lsk_attn import _channels, _check, _check_param, _epilogue_cuda, \
    epilogue_refusal

CHANNEL_MULTIPLE = 8           # C and hidden of the sub-block: 16-byte vectors
TAPS = 9                       # dwconv's (3x3)
DW_ROWS = (16, 8, 4)           # lsk_dw_gelu's tile rows, largest first
DW_COLS, DW_SLICE = 16, 64     # its tile columns and channels a block
DW_BLOCKS_PER_SM = 2           # resident at 16 rows (two buffers of 41 KB)


class Pack(NamedTuple):
    """One MLP sub-block's weights as the route reads them, from
    :func:`pack`. Products (Cout, Cin) and per-channel vectors in the
    compute dtype; dwconv's taps and bias in float32, rounded to the
    compute dtype first, where the eager route casts them."""
    w1: torch.Tensor           # (hidden, C) fc1 with norm2's scale folded in
    b1: torch.Tensor           # (hidden,) its bias, norm2's shift folded in
    taps: torch.Tensor         # (9, hidden) f32, dwconv's taps
    bd: torch.Tensor           # (hidden,) f32, dwconv's bias
    w2: torch.Tensor           # (C, hidden) fc2
    b2: torch.Tensor           # (C,)
    ls: torch.Tensor           # (C,) layer_scale_2


def pack(dtype, norm, fc1, dwconv, fc2, layer_scale):
    """The route's weights in ``dtype``: ``norm`` is norm2's float32
    ``(inv, shift)``, each conv a ``(weight, bias)`` of float32 parameters
    (as ``models/lsknet.py`` holds them), ``layer_scale`` (C,). ``norm2``
    folds into ``fc1`` in float32, ``W1 diag(inv)`` and ``b1 + W1 shift``,
    each then rounded to ``dtype`` once."""
    inv, shift = (t.float() for t in norm)

    def mat(w):
        return w.float().reshape(w.shape[0], -1)

    def rounded(t):
        return t.to(dtype).float().contiguous()

    w1 = mat(fc1[0])
    return Pack(w1=(w1 * inv).to(dtype), b1=(fc1[1] + w1 @ shift).to(dtype),
                taps=rounded(mat(dwconv[0]).t()), bd=rounded(dwconv[1]),
                w2=mat(fc2[0]).to(dtype), b2=fc2[1].to(dtype),
                ls=layer_scale.to(dtype))


def refusal(x, hidden, *needs):
    """The sub-block's contract on its (B, C, H, W) map ``x`` and ``hidden``
    channels: bf16 channels_last, C and hidden in 16-byte vectors, then
    :func:`route.refusal`."""
    c = x.shape[1]
    if c % CHANNEL_MULTIPLE or hidden % CHANNEL_MULTIPLE:
        return (f'the kernels take C and hidden % {CHANNEL_MULTIPLE} == 0, '
                f'not {c} and {hidden}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        return 'the kernels take channels_last maps'
    return route.refusal(x, x.dtype, x, *needs)


def mlp(x, p):
    """``x + layer_scale_2 * MLP(norm2(x))`` of a (B, C, H, W) map on the
    route, from the block's :class:`Pack` ``p``; (B, C, H, W) channels_last
    in ``x``'s dtype."""
    xh = x.permute(0, 2, 3, 1)
    g = dw_gelu(F.linear(xh, p.w1), p.b1, p.taps, p.bd)
    return bias_scale(F.linear(g, p.w2), p.b2, xh, p.ls).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# lsk_dw_gelu
# ---------------------------------------------------------------------------

def dw_gelu_refusal(h, *needs):
    """``lsk_dw_gelu``'s contract: bf16 ``h``, C % 8 == 0."""
    return _channels(h, CHANNEL_MULTIPLE) or \
        route.refusal(h, h.dtype, h, *needs)


def dw_gelu_reference(h, b1, w, bd):
    """(B, H, W, C) -> (B, H, W, C): ``GELU(dwconv(h + b1) + bd)``, ``h +
    b1`` zero outside the map, all in float32 and rounded to ``h``'s dtype
    once. ``w`` (9, C): the taps, row-major."""
    c = h.shape[-1]
    hb = (h.float() + b1.float()).permute(0, 3, 1, 2)
    d = F.conv2d(hb, w.t().reshape(c, 1, 3, 3), bd, padding=1, groups=c)
    return F.gelu(d).to(h.dtype).permute(0, 2, 3, 1)


def dw_tile(b, h, w, c, sms):
    """``lsk_dw_gelu``'s tile rows: the largest of DW_ROWS that gives each
    of DW_BLOCKS_PER_SM persistent blocks an SM two tiles or more (one
    computed while the next is copied in), else the smallest."""
    a_row = b * math.ceil(w / DW_COLS) * math.ceil(c / DW_SLICE)
    for rows in DW_ROWS:
        if a_row * math.ceil(h / rows) >= 2 * DW_BLOCKS_PER_SM * sms:
            return rows
    return DW_ROWS[-1]


def dw_gelu_cuda(h, b1, w, bd):
    """Launch ``lsk_dw_gelu``: (B, H, W, C) bf16 on a card -> (B, H, W,
    C)."""
    route.check(dw_gelu_refusal(h, b1, w, bd), 'lsk_dw_gelu')
    n, hh, ww, c = h.shape
    _check(h, (n, hh, ww, c), 'lsk_dw_gelu: h')
    _check_param(b1, (c,), torch.bfloat16, h.device, 'lsk_dw_gelu: b1')
    for t, shape, what in ((w, (TAPS, c), 'taps'), (bd, (c,), 'bd')):
        _check_param(t, shape, torch.float32, h.device, f'lsk_dw_gelu: {what}')
    out = torch.empty_like(h)
    sms = _ext.sm_count(h.device)
    _ext.launch('lsk_dw_gelu', h.data_ptr(), b1.data_ptr(), w.data_ptr(),
                bd.data_ptr(), out.data_ptr(), n, hh, ww, c,
                dw_tile(n, hh, ww, c, sms), sms,
                _ext.current_stream(h.device))
    return out


def dw_gelu(h, b1, w, bd):
    """The kernel where :func:`dw_gelu_refusal` holds, the plain form
    otherwise."""
    if dw_gelu_refusal(h, b1, w, bd) is None:
        return dw_gelu_cuda(h, b1, w, bd)
    return dw_gelu_reference(h, b1, w, bd)


# ---------------------------------------------------------------------------
# lsk_bias_scale: fc2's bias and the layer-scaled residual, in place
# ---------------------------------------------------------------------------

def bias_scale_reference(a, bias, x, ls):
    """``x + ls * (a + bias)``, as the eager route's bias add and
    ``addcmul`` round."""
    return torch.addcmul(x, ls, a + bias)


def bias_scale_cuda(a, bias, x, ls):
    """Launch ``lsk_bias_scale`` on (..., C) bf16 ``a`` and ``x``, in place
    in ``a``."""
    return _epilogue_cuda('lsk_bias_scale', a, bias, x, ls)


def bias_scale(a, bias, x, ls):
    """The kernel (in place in ``a``) where ``lsk_attn.epilogue_refusal``
    holds, the plain form otherwise."""
    if epilogue_refusal(a, bias, x, ls) is None:
        return bias_scale_cuda(a, bias, x, ls)
    return bias_scale_reference(a, bias, x, ls)
