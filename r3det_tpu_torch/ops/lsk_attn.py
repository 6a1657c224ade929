"""LSKNet's attention sub-block on the bf16 serving path: plain PyTorch
forms and the CUDA kernels (``csrc/lsk_attn.cu``).

``models/lsknet.py::Block`` runs ``x + layer_scale_1 * Attn(norm1(x))``
through :func:`attention` where :func:`refusal` holds: four products on
the NHWC view (``F.linear``: cuBLAS, no bias) and five passes, each
intermediate written once and read once, channels_last, no layout copy:

1. ``proj_1``'s product of ``x``, ``norm1`` folded into its weight and
   bias (:func:`pack`), then :func:`bias_gelu`: its bias and exact GELU,
   giving ``v``;
2. :func:`taps`: ``a1 = conv0(v) + b0`` (5x5 depthwise) and ``a2 =
   conv_spatial(a1) + bs`` (7x7 depthwise, dilation 3) side by side in one
   2C-channel map, ``a1`` zero outside the map as ``conv_spatial`` pads it;
3. ``conv1`` and ``conv2`` as one product of that map by a block-diagonal
   weight, then :func:`select`: their biases, each position's channel mean
   and max, ``conv_squeeze`` and the sigmoid in float32, and ``m = b1 *
   s0 + b2 * s1``;
4. ``conv``'s product of ``m``, then :func:`bias_gate`: its bias and the
   gate ``v * (.)``;
5. ``proj_2``'s product, then :func:`bias_residual`: its bias, the
   shortcut ``u = norm1(x)`` recomputed from ``x``, and ``x +
   layer_scale_1 * (.)``.

Each pass has a contract (``*_refusal``), a plain form (``*_reference``,
which repeats the kernel's arithmetic and roundings and is what the kernel
is held to; in float32 on the CPU it is the eager module's ops), a
``*_cuda`` wrapper that raises where the contract does not hold, and a
public entry that takes the kernel where it holds and the plain form
otherwise. Maps are (B, H, W, channels). The JAX package has no LSKNet,
so no TPU kernel stands behind any of them.

The block's MLP sub-block has its own route, ``ops/lsk_mlp.py``: its two
passes live in the same CUDA file, and its last one, fc2's bias and the
layer-scaled residual, is the epilogue template here without the
shortcut (``_epilogue_cuda``, ``lsk_bias_scale``).
"""
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _ext
from . import route

TAPS0, TAPS1 = 25, 49          # conv0's taps (5x5), conv_spatial's (7x7)
CHANNEL_MULTIPLE = 16          # C of the sub-block: C / 2 in 16-byte vectors
SELECT_TILES = (32, 16, 8)     # the selection's tile sides, largest first


class Pack(NamedTuple):
    """One attention sub-block's weights as the route reads them, from
    :func:`pack`. Products (Cout, Cin) and per-channel vectors in the
    compute dtype; the taps' and the selection's parameters in float32,
    rounded to the compute dtype first where the eager route casts them."""
    w1: torch.Tensor           # (C, C) proj_1 with norm1's scale folded in
    b1: torch.Tensor           # (C,) its bias with norm1's shift folded in
    taps: torch.Tensor         # (74, C) f32: conv0's 25 taps, then conv_spatial's 49
    b0: torch.Tensor           # (C,) f32, conv0's bias
    bs: torch.Tensor           # (C,) f32, conv_spatial's bias
    w12: torch.Tensor          # (C, 2C): conv1 on a1 | conv2 on a2
    b12: torch.Tensor          # (C,) f32: conv1's bias | conv2's bias
    wq: torch.Tensor           # (2, 2, 7, 7) f32, conv_squeeze
    bq: torch.Tensor           # (2,) f32
    w3: torch.Tensor           # (C, C / 2) conv
    b3: torch.Tensor           # (C,)
    w2: torch.Tensor           # (C, C) proj_2
    b2: torch.Tensor           # (C,)
    inv: torch.Tensor          # (C,) norm1's scale, as BatchNorm.affine
    shift: torch.Tensor        # (C,) norm1's shift
    ls: torch.Tensor           # (C,) layer_scale_1


def pack(dtype, norm, proj_1, conv0, conv_spatial, conv1, conv2,
         conv_squeeze, conv, proj_2, layer_scale):
    """The route's weights in ``dtype``: ``norm`` is norm1's float32
    ``(inv, shift)``, each conv a ``(weight, bias)`` of float32 parameters
    (as ``models/lsknet.py`` holds them), ``layer_scale`` (C,).
    ``norm1`` folds into ``proj_1`` in float32, ``W1 diag(inv)`` and ``b1
    + W1 shift``, each then rounded to ``dtype`` once."""
    inv, shift = (t.float() for t in norm)

    def mat(w):
        return w.float().reshape(w.shape[0], -1)

    def rounded(t):
        return t.to(dtype).float().contiguous()

    w1 = mat(proj_1[0])
    c = w1.shape[0]
    half = c // 2
    w12 = w1.new_zeros(c, 2 * c, dtype=dtype)
    w12[:half, :c] = mat(conv1[0])
    w12[half:, c:] = mat(conv2[0])
    taps = torch.cat([conv0[0].reshape(c, TAPS0),
                      conv_spatial[0].reshape(c, TAPS1)], 1).t()
    return Pack(
        w1=(w1 * inv).to(dtype), b1=(proj_1[1] + w1 @ shift).to(dtype),
        taps=rounded(taps), b0=rounded(conv0[1]), bs=rounded(conv_spatial[1]),
        w12=w12, b12=rounded(torch.cat([conv1[1], conv2[1]])),
        wq=conv_squeeze[0].float().contiguous(),
        bq=conv_squeeze[1].float().contiguous(),
        w3=mat(conv[0]).to(dtype), b3=conv[1].to(dtype),
        w2=mat(proj_2[0]).to(dtype), b2=proj_2[1].to(dtype),
        inv=inv.to(dtype), shift=shift.to(dtype), ls=layer_scale.to(dtype))


def refusal(x, *needs):
    """The sub-block's contract on its (B, C, H, W) map ``x``: bf16
    channels_last, C % 16 == 0, then :func:`route.refusal`."""
    if x.shape[1] % CHANNEL_MULTIPLE:
        return (f'the kernels take C % {CHANNEL_MULTIPLE} == 0, not '
                f'{x.shape[1]}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        return 'the kernels take channels_last maps'
    return route.refusal(x, x.dtype, x, *needs)


def attention(x, p):
    """``x + layer_scale_1 * Attn(norm1(x))`` of a (B, C, H, W) map on the
    route, from the block's :class:`Pack` ``p``; (B, C, H, W) channels_last
    in ``x``'s dtype."""
    xh = x.permute(0, 2, 3, 1)
    v = bias_gelu(F.linear(xh, p.w1), p.b1)
    m = select(F.linear(taps(v, p.taps, p.b0, p.bs), p.w12), p.b12, p.wq,
               p.bq)
    g = bias_gate(F.linear(m, p.w3), p.b3, v)
    y = bias_residual(F.linear(g, p.w2), p.b2, xh, p.inv, p.shift, p.ls)
    return y.permute(0, 3, 1, 2)


def _channels(t, multiple):
    c = t.shape[-1]
    if c % multiple:
        return f'the kernel takes C % {multiple} == 0, not {c}'
    return None


def _check(t, shape, what):
    if not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{what} must be a contiguous 16-byte aligned '
                         f'bfloat16 CUDA tensor of shape {shape}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}')


def _check_param(t, shape, dtype, device, what):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{what} must be a contiguous 16-byte aligned '
                         f'{dtype} tensor of shape {shape} on {device}')


# ---------------------------------------------------------------------------
# lsk_taps
# ---------------------------------------------------------------------------

def taps_refusal(v, *needs):
    """``lsk_taps``' contract: bf16 ``v``, C % 8 == 0."""
    return _channels(v, 8) or route.refusal(v, v.dtype, v, *needs)


def taps_reference(v, w, b0, bs):
    """(B, H, W, C) -> (B, H, W, 2C): ``a1 = conv0(v) + b0`` and ``a2 =
    conv_spatial(a1) + bs`` side by side, each summed in float32 and
    rounded to ``v``'s dtype once; ``a1`` is zero outside the map, as
    ``conv_spatial`` pads it. ``w`` (74, C): conv0's taps, then
    conv_spatial's, row-major."""
    c = v.shape[-1]
    w0 = w[:TAPS0].t().reshape(c, 1, 5, 5)
    ws = w[TAPS0:].t().reshape(c, 1, 7, 7)
    a1 = F.conv2d(v.permute(0, 3, 1, 2).float(), w0, b0, padding=2,
                  groups=c).to(v.dtype)
    a2 = F.conv2d(a1.float().contiguous(), ws, bs, padding=9, dilation=3,
                  groups=c).to(v.dtype)
    return torch.cat([a1.permute(0, 2, 3, 1), a2.permute(0, 2, 3, 1)], -1)


def taps_cuda(v, w, b0, bs):
    """Launch ``lsk_taps``: (B, H, W, C) bf16 on a card -> (B, H, W, 2C)."""
    route.check(taps_refusal(v, w, b0, bs), 'lsk_taps')
    b, h, wd, c = v.shape
    _check(v, (b, h, wd, c), 'lsk_taps: v')
    _check_param(w, (TAPS0 + TAPS1, c), torch.float32, v.device,
                 'lsk_taps: taps')
    for t, what in ((b0, 'b0'), (bs, 'bs')):
        _check_param(t, (c,), torch.float32, v.device, f'lsk_taps: {what}')
    out = torch.empty(b, h, wd, 2 * c, dtype=v.dtype, device=v.device)
    _ext.launch('lsk_taps', v.data_ptr(), w.data_ptr(), b0.data_ptr(),
                bs.data_ptr(), out.data_ptr(), b, h, wd, c,
                _ext.current_stream(v.device))
    return out


def taps(v, w, b0, bs):
    """The kernel where :func:`taps_refusal` holds, the plain form
    otherwise."""
    if taps_refusal(v, w, b0, bs) is None:
        return taps_cuda(v, w, b0, bs)
    return taps_reference(v, w, b0, bs)


# ---------------------------------------------------------------------------
# lsk_select
# ---------------------------------------------------------------------------

def select_refusal(b, *needs):
    """``lsk_select``'s contract: bf16 ``b``, C % 16 == 0."""
    return _channels(b, CHANNEL_MULTIPLE) or \
        route.refusal(b, b.dtype, b, *needs)


def select_reference(b, cb, wq, bq):
    """(B, H, W, C) -> (B, H, W, C / 2): with ``b1``, ``b2`` the two halves
    of ``b + cb`` (the biases added in ``b``'s dtype), ``s`` the sigmoid of
    ``conv_squeeze`` on their channel mean (the halves summed in float32)
    and max, in float32, rounded to ``b``'s dtype: ``b1 * s0 + b2 * s1``,
    as ``addcmul`` rounds it."""
    c = b.shape[-1]
    b = b + cb.to(b.dtype)
    b1, b2 = b[..., :c // 2], b[..., c // 2:]
    total = b1.sum(-1, keepdim=True, dtype=torch.float32) \
        + b2.sum(-1, keepdim=True, dtype=torch.float32)
    top = torch.maximum(b1.amax(-1, keepdim=True), b2.amax(-1, keepdim=True))
    agg = torch.cat([total / c, top.float()], -1).permute(0, 3, 1, 2)
    s = torch.sigmoid(F.conv2d(agg, wq, bq, padding=3)).to(b.dtype)
    s = s.permute(0, 2, 3, 1)
    return torch.addcmul(b1 * s[..., :1], b2, s[..., 1:])


def select_tile(b, h, w, sms):
    """The selection kernel's tile side: the largest of SELECT_TILES that
    gives at least two blocks an SM, else the smallest."""
    for t in SELECT_TILES:
        if b * math.ceil(h / t) * math.ceil(w / t) >= 2 * sms:
            return t
    return SELECT_TILES[-1]


def select_cuda(b, cb, wq, bq):
    """Launch ``lsk_select``: (B, H, W, C) bf16 on a card -> (B, H, W,
    C / 2)."""
    route.check(select_refusal(b, cb, wq, bq), 'lsk_select')
    n, h, w, c = b.shape
    _check(b, (n, h, w, c), 'lsk_select: b')
    for t, shape, what in ((cb, (c,), 'cb'), (wq, (2, 2, 7, 7), 'wq'),
                           (bq, (2,), 'bq')):
        _check_param(t, shape, torch.float32, b.device, f'lsk_select: {what}')
    out = torch.empty(n, h, w, c // 2, dtype=b.dtype, device=b.device)
    _ext.launch('lsk_select', b.data_ptr(), cb.data_ptr(), wq.data_ptr(),
                bq.data_ptr(), out.data_ptr(), n, h, w, c,
                select_tile(n, h, w, _ext.sm_count(b.device)),
                _ext.current_stream(b.device))
    return out


def select(b, cb, wq, bq):
    """The kernel where :func:`select_refusal` holds, the plain form
    otherwise."""
    if select_refusal(b, cb, wq, bq) is None:
        return select_cuda(b, cb, wq, bq)
    return select_reference(b, cb, wq, bq)


# ---------------------------------------------------------------------------
# The epilogues: a product's bias and what follows it, in place
# ---------------------------------------------------------------------------

def epilogue_refusal(a, *needs):
    """The epilogues' contract (``lsk_mlp.bias_scale``'s too): bf16 ``a``,
    C % 8 == 0."""
    return _channels(a, 8) or route.refusal(a, a.dtype, a, *needs)


def bias_gelu_reference(a, bias):
    """``GELU(a + bias)``, exact GELU; the bias add rounds."""
    return F.gelu(a + bias)


def bias_gate_reference(a, bias, v):
    """``v * (a + bias)``."""
    return v * (a + bias)


def bias_residual_reference(a, bias, x, inv, shift, ls):
    """``x + ls * (a + bias + u)`` with ``u = x * inv + shift`` (norm1 as
    ``BatchNorm`` computes it), as the eager route's adds and ``addcmul``
    round."""
    return torch.addcmul(x, ls, (a + bias) + torch.addcmul(shift, x, inv))


def _epilogue_cuda(name, a, bias, *rest):
    route.check(epilogue_refusal(a, bias, *rest), name)
    shape = tuple(a.shape)
    c = shape[-1]
    _check(a, shape, f'{name}: a')
    maps, vecs = rest[:1], rest[1:]
    for t in maps:
        _check(t, shape, f'{name}: the second map')
    for t in (bias, *vecs):
        _check_param(t, (c,), torch.bfloat16, a.device, f'{name}: a vector')
    _ext.launch(name, a.data_ptr(), bias.data_ptr(),
                *(t.data_ptr() for t in rest), a.numel() // c, c,
                _ext.sm_count(a.device), _ext.current_stream(a.device))
    return a


def bias_gelu_cuda(a, bias):
    """Launch ``lsk_bias_gelu`` on (..., C) bf16 ``a``, in place."""
    return _epilogue_cuda('lsk_bias_gelu', a, bias)


def bias_gate_cuda(a, bias, v):
    """Launch ``lsk_bias_gate`` on (..., C) bf16 ``a`` and ``v``, in place
    in ``a``."""
    return _epilogue_cuda('lsk_bias_gate', a, bias, v)


def bias_residual_cuda(a, bias, x, inv, shift, ls):
    """Launch ``lsk_bias_residual`` on (..., C) bf16 ``a`` and ``x``, in
    place in ``a``."""
    return _epilogue_cuda('lsk_bias_residual', a, bias, x, inv, shift, ls)


def bias_gelu(a, bias):
    """The kernel (in place in ``a``) where :func:`epilogue_refusal` holds,
    the plain form otherwise."""
    if epilogue_refusal(a, bias) is None:
        return bias_gelu_cuda(a, bias)
    return bias_gelu_reference(a, bias)


def bias_gate(a, bias, v):
    """As :func:`bias_gelu`, for the gate."""
    if epilogue_refusal(a, bias, v) is None:
        return bias_gate_cuda(a, bias, v)
    return bias_gate_reference(a, bias, v)


def bias_residual(a, bias, x, inv, shift, ls):
    """As :func:`bias_gelu`, for the shortcut and the layer-scaled
    residual."""
    if epilogue_refusal(a, bias, x, inv, shift, ls) is None:
        return bias_residual_cuda(a, bias, x, inv, shift, ls)
    return bias_residual_reference(a, bias, x, inv, shift, ls)
