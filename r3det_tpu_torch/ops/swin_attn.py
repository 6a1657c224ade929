"""Swin's window-attention sub-block on the bf16 serving path: plain
PyTorch forms and the CUDA kernels (``csrc/swin_attn.cu``).

``models/swin.py::ShiftWindowMSA.kernel_forward`` runs a block's
``norm1`` through its attention output in four steps:

1. :func:`norm_pad`: LayerNorm of the (B, H, W, C) block input, written
   into a (B, Hp, Wp, C) map padded with zeros at its bottom and right to
   a multiple of the window (zeros, not LN(0): mmdet pads after the norm);
2. the qkv product over every row of that map (``F.linear``: token order
   does not matter to it, so no window partition is made);
3. :func:`window_attn`: each shifted window's attention, read from the
   qkv map and written to each token's original place in a compact (B, H,
   W, C) map: the cyclic shift, the partition, its inverse, the crop, the
   q scale, the position bias and the shift mask are index arithmetic;
4. the proj product; the caller adds the residual.

The plain forms repeat the kernels' arithmetic and addressing (the
windows are gathered through the shift, the region of each token is read
off its rolled-map coordinates) and are what the kernels are held to;
every call their contracts refuse takes them. The JAX package has no
Swin, so no TPU kernel stands behind either.

Scores, bias, mask and softmax are float32; P is rounded to the input's
dtype before P.V, whose sums are float32 (``csrc/swin_attn.cu``).
"""
import torch
import torch.nn.functional as F

from .. import _ext
from . import route

HEAD_DIM = 32                  # the kernel's head width
MAX_TOKENS = 64                # window**2 a kernel block holds
MAX_NORM_WIDTH = 768           # C the norm kernel holds in registers
MASK_VALUE = -100.0            # mmdet's shifted-window mask


def _windows(dims, heads, window):
    if dims != heads * HEAD_DIM:
        return f'the kernels take head_dim {HEAD_DIM}, not {dims / heads:g}'
    if window * window > MAX_TOKENS:
        return f'the kernels take window**2 <= {MAX_TOKENS}, not {window}**2'


def norm_pad_refusal(x, *needs):
    """``swin_norm_pad``'s contract: bf16 ``x``, C % 8 == 0, C <= 768."""
    c = x.shape[-1]
    if c % 8 or c > MAX_NORM_WIDTH:
        return (f'the kernels take C a multiple of 8 up to '
                f'{MAX_NORM_WIDTH}, not {c}')
    return route.refusal(x, x.dtype, x, *needs)


def window_attn_refusal(qkv, heads, window, *needs):
    """``swin_window_attn``'s contract: bf16, head_dim 32, window**2 <= 64."""
    return _windows(qkv.shape[-1] // 3, heads, window) or \
        route.refusal(qkv, qkv.dtype, qkv, *needs)


def refusal(x, heads, window, *needs):
    """The attention sub-block's contract: both kernels', on its map ``x``."""
    return _windows(x.shape[-1], heads, window) or \
        norm_pad_refusal(x, *needs)


def _check(t, what):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{what} must be a contiguous 16-byte aligned '
                         f'tensor')


def _check_param(t, shape, device, what):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'{what} must be a contiguous float32 tensor of '
                         f'shape {shape} on {device}')


# ---------------------------------------------------------------------------
# norm1 and the pad
# ---------------------------------------------------------------------------

def norm_pad_reference(x, weight, bias, eps, hp, wp):
    """LayerNorm of ``x`` (B, H, W, C) over C, on the parameters cast to
    ``x``'s dtype as the eager route casts them, then zero-padded to (B,
    hp, wp, C)."""
    h, w = x.shape[1:3]
    y = F.layer_norm(x, x.shape[-1:], weight.to(x.dtype), bias.to(x.dtype),
                     eps)
    return F.pad(y, (0, 0, 0, wp - w, 0, hp - h))


def norm_pad_cuda(x, weight, bias, eps, hp, wp):
    """Launch ``swin_norm_pad``: (B, H, W, C) bf16 on a card, C a multiple
    of 8 up to ``MAX_NORM_WIDTH``, ``weight`` and ``bias`` (C,) float32 ->
    (B, hp, wp, C)."""
    b, h, w, c = x.shape
    route.check(norm_pad_refusal(x, weight, bias), 'swin_norm_pad')
    if hp < h or wp < w:
        raise ValueError(f'swin_norm_pad: a map of {h} x {w} padded to '
                         f'({hp}, {wp})')
    _check(x, 'swin_norm_pad: x')
    for t, what in ((weight, 'weight'), (bias, 'bias')):
        _check_param(t, (c,), x.device, f'swin_norm_pad: {what}')
    out = torch.empty(b, hp, wp, c, dtype=x.dtype, device=x.device)
    _ext.launch('swin_norm_pad', x.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, h, w, hp, wp, c,
                float(eps), _ext.sm_count(x.device),
                _ext.current_stream(x.device))
    return out


def norm_pad(x, weight, bias, eps, hp, wp):
    """The kernel where :func:`norm_pad_refusal` holds, the plain form
    otherwise."""
    if norm_pad_refusal(x, weight, bias) is None:
        return norm_pad_cuda(x, weight, bias, eps, hp, wp)
    return norm_pad_reference(x, weight, bias, eps, hp, wp)


# ---------------------------------------------------------------------------
# The windows' attention
# ---------------------------------------------------------------------------

def window_places(hp, wp, window, shift, device):
    """Each window's tokens, windows in row-major order: their place in the
    padded map, ``y * wp + x`` (nW, window**2), which is where the rolled
    map's token came from and where its output goes back, and their mask
    region (nW, window**2): mmdet's nine regions of the rolled map, cut at
    ``-window`` and ``-shift`` along each axis (all 0 without a shift)."""
    t = torch.arange(window * window, device=device)
    ry = (torch.arange(hp // window, device=device)[:, None] * window
          + t[None, :] // window)                            # (nWy, N)
    rx = (torch.arange(wp // window, device=device)[:, None] * window
          + t[None, :] % window)                             # (nWx, N)
    place = ((ry + shift) % hp)[:, None] * wp + ((rx + shift) % wp)[None]
    if shift:
        gy = (ry >= hp - window).long() + (ry >= hp - shift).long()
        gx = (rx >= wp - window).long() + (rx >= wp - shift).long()
        region = 3 * gy[:, None] + gx[None]
    else:
        region = torch.zeros_like(place)
    n = window * window
    return place.reshape(-1, n), region.reshape(-1, n)


def bias_index(window, device):
    """The (window**2, window**2) index of token pairs into the bias
    table: ``(iy - jy + w - 1) * (2w - 1) + (ix - jx + w - 1)``."""
    t = torch.arange(window * window, device=device)
    ty, tx = t // window, t % window
    return ((ty[:, None] - ty[None] + window - 1) * (2 * window - 1)
            + tx[:, None] - tx[None] + window - 1)


def window_attn_reference(qkv, table, heads, window, shift, h, w):
    """qkv (B, Hp, Wp, 3C), ``table`` ((2w - 1)**2, heads) -> (B, h, w, C)
    in qkv's dtype: the attention of the windows of the map rolled by
    ``-shift``, each token's output at its place before the roll, the pad
    cropped."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    n = window * window
    place, region = window_places(hp, wp, window, shift, qkv.device)
    nw = place.shape[0]
    t = qkv.reshape(b, hp * wp, 3, heads, d)[:, place.reshape(-1)]
    q, k, v = t.view(b, nw, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    scores = q.float() @ k.float().transpose(-2, -1) * (d ** -0.5)
    bias = table.float()[bias_index(window, qkv.device)].permute(2, 0, 1)
    if shift:
        mask = torch.where(region[:, :, None] != region[:, None, :],
                           MASK_VALUE, 0.0)                  # (nW, N, N)
        bias = bias + mask[:, None]
    p = (scores + bias).softmax(-1).to(qkv.dtype)
    o = (p.float() @ v.float()).to(qkv.dtype)                # (B,nW,hd,N,d)
    out = qkv.new_empty(b, hp * wp, c)
    out[:, place.reshape(-1)] = o.permute(0, 1, 3, 2, 4).reshape(b, -1, c)
    return out.view(b, hp, wp, c)[:, :h, :w].contiguous()


def window_attn_cuda(qkv, table, heads, window, shift, h, w):
    """Launch ``swin_window_attn``: qkv (B, Hp, Wp, 3C) bf16 on a card,
    ``table`` ((2 * window - 1)**2, heads) float32 -> (B, h, w, C)."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    route.check(window_attn_refusal(qkv, heads, window, table),
                'swin_window_attn')
    if c3 % 3 or hp % window or wp % window or hp < h or wp < w \
            or not 0 <= shift < window:
        raise ValueError(f'swin_window_attn: qkv {tuple(qkv.shape)} is no '
                         f'padded map of {h} x {w} in windows of {window} '
                         f'(shift {shift})')
    _check(qkv, 'swin_window_attn: qkv')
    _check_param(table, ((2 * window - 1) ** 2, heads), qkv.device,
                 'swin_window_attn: table')
    out = torch.empty(b, h, w, c, dtype=qkv.dtype, device=qkv.device)
    _ext.launch('swin_window_attn', qkv.data_ptr(), table.data_ptr(),
                out.data_ptr(), b, h, w, hp, wp, c, heads, window, shift,
                HEAD_DIM ** -0.5, _ext.current_stream(qkv.device))
    return out


def window_attn(qkv, table, heads, window, shift, h, w):
    """The kernel where :func:`window_attn_refusal` holds, the plain form
    otherwise."""
    if window_attn_refusal(qkv, heads, window, table) is None:
        return window_attn_cuda(qkv, table, heads, window, shift, h, w)
    return window_attn_reference(qkv, table, heads, window, shift, h, w)
