"""Swin Transformer backbone (Liu et al., arXiv:2103.14030), as mmdet 2.x
builds it (``mmdet/models/backbones/swin.py``: ``SwinTransformer``,
``SwinBlockSequence``, ``SwinBlock``, ``ShiftWindowMSA``, ``WindowMSA``;
``PatchEmbed`` and ``PatchMerging`` of ``mmdet/models/utils``).

The JAX package has no Swin; this module has no counterpart there. Module,
parameter and buffer names are mmdet's (``stages.1.blocks.0.attn.w_msa.
qkv.weight``, ``stages.0.downsample.reduction.weight``, ``norm3.bias``),
so one state dict serves this module and the benchmark's plain
reference. Drop-path and dropout are left out: they are inert at
inference, and training a Swin is not provided.

- ``patch_embed``: a ``patch_size`` x ``patch_size`` conv of that stride
  (bias) on the image, its bottom and right zero-padded to a multiple of
  the patch ('corner'), then LayerNorm.
- Each block: LayerNorm, then the window attention sub-block: the map
  zero-padded at its bottom and right to a multiple of the window (after
  the norm, and not masked: padded tokens take part in attention), on odd
  blocks rolled by ``-window // 2`` with mmdet's nine-region mask of -100
  built on the padded map, split into windows, multi-head attention with
  the qkv bias, the scale ``head_dim ** -0.5`` and the relative-position
  bias (a ``(2 * window - 1) ** 2`` by heads table gathered by mmdet's
  ``double_step_seq`` index), the windows merged, rolled back, cropped
  and added to the block input. Then LayerNorm, fc1, exact GELU, fc2 and
  the residual.
- Between stages ``PatchMerging``: the map padded to even sides, each 2x2
  neighbourhood's 4C values in ``nn.Unfold``'s order (channel-major, then
  row, then column), LayerNorm(4C) and Linear(4C -> 2C), no bias.
- Each stage in ``out_indices`` leaves through a LayerNorm (``norm{i}``).

The input is the NHWC image; the outputs are NCHW maps (channels_last
memory) with ``out_channels`` channels. Parameters stay float32 and every
layer computes in ``dtype``, as the ResNet does: LayerNorm, softmax and
GELU take their statistics in float32 (PyTorch's kernels do for bf16),
the matrix products accumulate in float32. The shift mask and the
gathered position bias, added together, are made on the device once per
(map size, dtype, device) and version of the table, and kept
(``WindowMSA.bias``): the forward makes no host-to-device copy and reads
nothing back.

Where the sub-block's contract holds (``ops/swin_attn.py::refusal``: bf16
on a card, no gradient, head_dim 32, C up to 768, window**2 <= 64), a
block runs ``norm1`` through its attention output as two CUDA kernels
around the qkv and proj products (``ShiftWindowMSA.kernel_forward``): the
pad, shift, windows, crop, bias and mask are their addressing. Everything
else takes the plain code below, which the kernels are held to.

Spans (``utils/tracing.py``): ``backbone.swin.embed``;
``backbone.swin.attn`` (each block, from ``norm1`` through the residual
add) and ``backbone.swin.mlp`` (each block); ``backbone.swin.merge``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import swin_attn
from ..ops.swin_attn import MASK_VALUE  # mmdet's shifted-window mask
from ..utils.tracing import span
from .conv import Conv2d


class Linear(nn.Linear):
    """A linear layer that computes in its input's dtype on float32
    parameters, as :class:`.conv.Conv2d` does."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in its input's dtype on float32 parameters."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def relative_position_index(window):
    """mmdet's ``(window**2, window**2)`` index into the bias table:
    ``double_step_seq(2 * window - 1, window, 1, window)`` added to its
    transpose, flipped along the columns."""
    seq = (torch.arange(0, (2 * window - 1) * window, 2 * window - 1)[:, None]
           + torch.arange(window)[None, :]).reshape(1, -1)
    return (seq + seq.T).flip(1).contiguous()


def window_partition(x, window):
    """(B, H, W, C), H and W multiples of ``window`` -> (B * nW,
    window**2, C), windows in row-major order within each image."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows, window, h, w):
    """:func:`window_partition`'s inverse: -> (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def cyclic_shift(x, shift):
    """(B, H, W, C) rolled by ``shift`` along H and W."""
    return torch.roll(x, (shift, shift), (1, 2))


def padded(n, window):
    return n + (window - n % window) % window


def attn_mask(h, w, window, shift, device):
    """The shifted-window mask of an ``h`` x ``w`` map, (nW, window**2,
    window**2) float32: mmdet's nine regions of the padded map (its
    slices), -100 between tokens of different regions, 0 within one.
    None for an unshifted block."""
    if not shift:
        return None
    hp, wp = padded(h, window), padded(w, window)
    img = torch.zeros(1, hp, wp, 1, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = cnt
            cnt += 1
    regions = window_partition(img, window).view(-1, window * window)
    diff = regions[:, None, :] - regions[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


class WindowMSA(nn.Module):
    """Multi-head self-attention within windows, with the relative
    position bias."""

    def __init__(self, dims, heads, window):
        super().__init__()
        self.num_heads = heads
        self.window = window
        self.scale = (dims // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window))
        self.qkv = Linear(dims, 3 * dims)
        self.proj = Linear(dims, dims)
        self._bias = (None, None)

    def position_bias(self):
        """(heads, N, N) float32, N = window**2."""
        n = self.window * self.window
        table = self.relative_position_bias_table
        return table[self.relative_position_index.view(-1)].view(
            n, n, -1).permute(2, 0, 1)

    def bias(self, h, w, shift, dtype, device):
        """What the scores of an ``h`` x ``w`` map's windows take before
        the softmax, in ``dtype``: the position bias, (1, heads, N, N),
        and with ``shift`` the mask added, (nW, heads, N, N). Without
        autograd kept until the map size, dtype, device or table
        changes."""
        def make():
            b = self.position_bias().to(dtype)[None]
            mask = attn_mask(h, w, self.window, shift, device)
            return b if mask is None else b + mask.to(dtype)[:, None]
        if torch.is_grad_enabled():
            return make()
        t = self.relative_position_bias_table
        key = (h, w, shift, dtype, device, t.data_ptr(), t._version)
        if self._bias[0] != key:
            self._bias = (key, make())
        return self._bias[1]

    def forward(self, x, bias):
        """x (B * nW, N, C) -> (B * nW, N, C); ``bias`` (1 or nW, heads,
        N, N)."""
        bw, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(bw, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)     # (BnW, h, N, N)
        nw = bias.shape[0]
        attn = (attn.view(-1, nw, heads, n, n) + bias).view(bw, heads, n, n)
        attn = attn.softmax(-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(bw, n, c))


class ShiftWindowMSA(nn.Module):
    """Window attention on a (B, H, W, C) map: the pad, the cyclic shift
    and its mask, the windows and back."""

    def __init__(self, dims, heads, window, shift):
        super().__init__()
        self.window = window
        self.shift = shift
        self.w_msa = WindowMSA(dims, heads, window)

    def forward(self, x):
        h, w = x.shape[1:3]
        win, s = self.window, self.shift
        hp, wp = padded(h, win), padded(w, win)
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        if s:
            x = cyclic_shift(x, -s)
        bias = self.w_msa.bias(h, w, s, x.dtype, x.device)
        x = self.w_msa(window_partition(x, win), bias)
        x = window_reverse(x, win, hp, wp)
        if s:
            x = cyclic_shift(x, s)
        return x[:, :h, :w]

    def kernel_forward(self, x, norm):
        """``self(norm(x))`` through ``ops/swin_attn.py``: ``norm`` and the
        pad in one pass, the qkv product over the padded map, the windows'
        attention from it (the shift, windows, bias and mask as addressing)
        into a compact (B, H, W, C) map, and the proj product."""
        h, w = x.shape[1:3]
        win, msa = self.window, self.w_msa
        y = swin_attn.norm_pad(x, norm.weight, norm.bias, norm.eps,
                               padded(h, win), padded(w, win))
        y = swin_attn.window_attn(
            msa.qkv(y), msa.relative_position_bias_table, msa.num_heads, win,
            self.shift, h, w)
        return msa.proj(y)


class FFN(nn.Module):
    """mmcv's two-layer FFN (``layers.0.0`` fc1, exact GELU, ``layers.1``
    fc2)."""

    def __init__(self, dims, hidden):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(dims, hidden), nn.GELU()),
            Linear(hidden, dims))

    def forward(self, x):
        return self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, dims, heads, hidden, window, shift):
        super().__init__()
        self.norm1 = LayerNorm(dims)
        self.attn = ShiftWindowMSA(dims, heads, window,
                                   window // 2 if shift else 0)
        self.norm2 = LayerNorm(dims)
        self.ffn = FFN(dims, hidden)

    def forward(self, x):
        with span('backbone.swin.attn'):
            if swin_attn.refusal(x, self.attn.w_msa.num_heads,
                                 self.attn.window, self.norm1.weight) is None:
                x = x + self.attn.kernel_forward(x, self.norm1)
            else:
                x = x + self.attn(self.norm1(x))
        with span('backbone.swin.mlp'):
            return x + self.ffn(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dims, patch):
        super().__init__()
        self.patch = patch
        self.projection = Conv2d(3, dims, patch, stride=patch)
        self.norm = LayerNorm(dims)

    def forward(self, x):
        """NCHW image -> (B, H / patch, W / patch, C)."""
        h, w = x.shape[2:]
        p = self.patch
        x = F.pad(x, (0, padded(w, p) - w, 0, padded(h, p) - h))
        return self.norm(self.projection(x).permute(0, 2, 3, 1))


class PatchMerging(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.norm = LayerNorm(4 * dims)
        self.reduction = Linear(4 * dims, 2 * dims, bias=False)

    def forward(self, x):
        """(B, H, W, C) -> (B, ceil(H / 2), ceil(W / 2), 2C)."""
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        x = x.view(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h2, w2, 4 * c)))


class SwinBlockSequence(nn.Module):
    def __init__(self, dims, heads, depth, window, mlp_ratio, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dims, heads, mlp_ratio * dims, window, i % 2 == 1)
            for i in range(depth))
        self.downsample = PatchMerging(dims) if downsample else None


class SwinTransformer(nn.Module):
    """NHWC image (B, H, W, 3) -> the ``out_indices`` stages' maps, NCHW
    channels_last, in ``dtype``; the attention sub-blocks run the CUDA
    kernels where they take them."""

    def __init__(self, embed_dims=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4,
                 patch_size=4, out_indices=(1, 2, 3), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dims, patch_size)
        self.stages = nn.ModuleList()
        dims = embed_dims
        widths = []
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            last = i == len(depths) - 1
            self.stages.append(SwinBlockSequence(
                dims, heads, depth, window_size, mlp_ratio, not last))
            widths.append(dims)
            dims *= 2
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm(widths[i]))
        self.out_channels = tuple(widths[i] for i in self.out_indices)

    def forward(self, images):
        with span('backbone.swin.embed'):
            x = self.patch_embed(images.to(self.dtype).permute(0, 3, 1, 2))
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                with span('backbone.swin.merge'):
                    x = stage.downsample(x)
        return tuple(outs)
