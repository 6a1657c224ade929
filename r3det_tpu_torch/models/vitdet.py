"""ViTDet's plain ViT backbone (Li, Mao, Girshick, He, "Exploring Plain
Vision Transformer Backbones for Object Detection", ECCV 2022,
arXiv:2203.16527), as detectron2's ``modeling/backbone/vit.py`` builds it
(``ViT``, ``Block``, ``Attention``, ``PatchEmbed``, ``get_abs_pos``,
``get_rel_pos``, ``add_decomposed_rel_pos``, ``window_partition``,
``window_unpartition``), with three levels of its ``SimpleFeaturePyramid``.

The JAX package has no ViT; this module has no counterpart there. Module
and parameter names are detectron2's (``patch_embed.proj.weight``,
``pos_embed``, ``blocks.2.attn.rel_pos_h``, ``blocks.0.mlp.fc2.bias``,
``simfp_3.0.weight``), so one state dict serves this module and the
benchmark's plain reference. Drop-path is left out: it is inert at
inference, and training a ViT is not provided.

- ``patch_embed.proj``: a ``patch`` x ``patch`` conv of that stride (bias)
  on the image, to a (B, H, W, C) token grid.
- ``pos_embed`` (1, 1 + grid**2, C), pretrained at a ``pretrain_grid``
  square with a cls row: the cls row dropped, the rest resized bicubically
  (``align_corners=False``) to the token grid and added once.
- Each block ``blocks.{i}``: ``x + Attn(norm1(x))``, then ``x +
  fc2(GELU(fc1(norm2(x))))``; LayerNorm eps 1e-6, exact GELU, no layer
  scale, no norm after the last block. A window block zero-pads
  ``norm1``'s output at its bottom and right to a multiple of the window
  and attends within each window; the pad is not masked (a padded token's
  q, k and v are the qkv bias). A global block (``global_blocks``) attends
  over the whole grid.
- ``Attn`` over an Hq x Wq grid: ``qkv`` splits into heads of d; the logit
  of query i and key j is ``d**-0.5 q_i.k_j + q_i.Rh[i_h - j_h + Hq - 1] +
  q_i.Rw[i_w - j_w + Wq - 1]``, the relative terms on the unscaled q, with
  ``Rh`` = ``rel_pos_h`` and ``Rw`` = ``rel_pos_w`` ((2 Hq - 1, d) each, one
  pair a block, shared by the heads; a window's size, or the built image's
  grid for a global block). At another grid each table is resized
  linearly to 2 max(q, k) - 1 rows first (``get_rel_pos``). Softmax, P.v,
  the heads concatenated, ``proj``.
- The pyramid on the last block's stride-``patch`` map (the
  ``SimpleFeaturePyramid``'s scale factors 2, 1 and 0.5):
  ``simfp_3.0`` = ConvTranspose2d(C, C/2, 2, stride 2) with bias, the map
  itself, and a 2 x 2 max pool.

The input is the NHWC image; the outputs are the three NCHW maps
(channels_last memory), ``out_channels`` = (C/2, C, C). Parameters stay
float32 and every layer computes in ``dtype``: LayerNorm, GELU and the
softmax take their statistics in float32 (PyTorch's kernels do for bf16),
the products accumulate in float32. The attention is one
``F.scaled_dot_product_attention`` call (cuDNN's fused kernel on the
card) on widened q and k (``Attention.augmented``): q takes the two
relative terms of its row and column as d**-0.5 q's neighbours, k a
one-hot of its row and column, so that q'.k' is the whole logit; no
logits and no (N, N) bias are kept (at batch 8 of 1024^2, H100: a
global sub-block 2.80 ms this way, 11.69 with the terms summed into an
additive bias, 21.10 written out). The relative tables gathered for a
grid (``Attention.rel_tables``), the keys' one-hot columns
(``Attention.key_columns``) and the resized position table
(``ViT.abs_pos``) are made on the device once a grid, dtype and table
version and kept: the forward makes no host-to-device copy and reads
nothing back.

Spans (``utils/tracing.py``): ``backbone.vit.embed`` (the patch embedding
and the position), ``backbone.vit.window_attn`` and
``backbone.vit.global_attn`` (each block's ``norm1`` through its residual
add), ``backbone.vit.mlp`` (each block's ``norm2`` through its residual
add) and ``backbone.vit.pyramid``.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.tracing import span
from .conv import Conv2d
from .swin import LayerNorm, Linear, padded, window_partition, window_reverse

LN_EPS = 1e-6


def _kept(owner, attr, key, make):
    """``make()``, kept on ``owner.<attr>`` under ``key`` while autograd is
    off; made afresh under autograd."""
    if torch.is_grad_enabled():
        return make()
    cached = getattr(owner, attr)
    if cached[0] != key:
        setattr(owner, attr, (key, make()))
    return getattr(owner, attr)[1]


def _version(t):
    return t.data_ptr(), t._version


def rel_pos(table, q, k):
    """detectron2's ``get_rel_pos``: the (q, k, d) rows of ``table`` for
    query positions 0..q-1 against key positions 0..k-1, the table first
    resized linearly to 2 max(q, k) - 1 rows where it has another count."""
    n = 2 * max(q, k) - 1
    if table.shape[0] != n:
        table = F.interpolate(table.t()[None], size=n, mode='linear')[0].t()
    qc = torch.arange(q, device=table.device)[:, None] * max(k / q, 1.0)
    kc = torch.arange(k, device=table.device)[None, :] * max(q / k, 1.0)
    return table[(qc - kc + (k - 1) * max(q / k, 1.0)).long()]


class Attention(nn.Module):
    """Multi-head self-attention over a (B, H, W, C) grid with the
    decomposed relative positions."""

    def __init__(self, dim, heads, grid):
        super().__init__()
        self.num_heads = heads
        head_dim = dim // heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid - 1, head_dim))
        self._tables = self._keys = (None, None)

    def rel_tables(self, h, w, dtype):
        """(Rh (h, h, d), Rw (w, w, d)) in ``dtype`` for an h x w grid."""
        th, tw = self.rel_pos_h, self.rel_pos_w
        key = (h, w, dtype, th.device, _version(th), _version(tw))
        return _kept(self, '_tables', key, lambda: (
            rel_pos(th, h, h).to(dtype), rel_pos(tw, w, w).to(dtype)))

    def key_columns(self, h, w, pad, dtype, device):
        """(N, h + w + pad), N = h w: key j's one-hot row j_h, its one-hot
        column j_w and ``pad`` zeros, in ``dtype``."""
        def make():
            j = torch.arange(h * w, device=device)
            rows = torch.arange(h, device=device)
            cols = torch.arange(w, device=device)
            return torch.cat([(j[:, None] // w == rows).to(dtype),
                              (j[:, None] % w == cols).to(dtype),
                              torch.zeros(h * w, pad, dtype=dtype,
                                          device=device)], 1)
        return _kept(self, '_keys', (h, w, pad, dtype, device), make)

    def augmented(self, q, k, h, w):
        """q and k (B, heads, N, d) of an h x w grid widened so that their
        product is the whole logit: ``q' = [d**-0.5 q, q.Rh[i_h, :],
        q.Rw[i_w, :], 0]`` (the relative terms on the unscaled q) and ``k' =
        [k, onehot(j_h), onehot(j_w), 0]``, d + h + w columns padded to a
        multiple of 8 with zeros."""
        rh, rw = self.rel_tables(h, w, q.dtype)
        r = q.unflatten(2, (h, w))
        rel_h = torch.einsum('bnhwd,hkd->bnhwk', r, rh).flatten(2, 3)
        rel_w = torch.einsum('bnhwd,wkd->bnhwk', r, rw).flatten(2, 3)
        pad = -(q.shape[-1] + h + w) % 8
        parts = [q * self.scale, rel_h, rel_w]
        if pad:
            parts.append(q.new_zeros(*q.shape[:-1], pad))
        cols = self.key_columns(h, w, pad, k.dtype, k.device)
        return torch.cat(parts, -1), torch.cat(
            [k, cols.expand(*k.shape[:-1], -1)], -1)

    def forward(self, x):
        b, h, w, c = x.shape
        heads = self.num_heads
        q, k, v = self.qkv(x).view(b, h * w, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        qa, ka = self.augmented(q, k, h, w)
        y = F.scaled_dot_product_attention(qa, ka, v, scale=1.0)
        return self.proj(y.transpose(1, 2).reshape(b, h, w, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A window block (``window`` > 0) or a global one (``window`` 0, its
    tables built for a ``grid`` x ``grid`` map)."""

    def __init__(self, dim, heads, mlp_ratio, window, grid):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, window or grid)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def windowed(self, y):
        """``attn`` within each window of the zero-padded map ``y``."""
        b, h, w, c = y.shape
        win = self.window
        hp, wp = padded(h, win), padded(w, win)
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        y = self.attn(window_partition(y, win).view(-1, win, win, c))
        return window_reverse(y.view(-1, win * win, c), win, hp, wp)[
            :, :h, :w]

    def forward(self, x):
        if self.window:
            with span('backbone.vit.window_attn'):
                x = x + self.windowed(self.norm1(x))
        else:
            with span('backbone.vit.global_attn'):
                x = x + self.attn(self.norm1(x))
        with span('backbone.vit.mlp'):
            return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        """NCHW image -> (B, H / patch, W / patch, C)."""
        return self.proj(x).permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """A transposed conv in its input's dtype on float32 parameters."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride)


class ViT(nn.Module):
    """NHWC image (B, H, W, 3) -> the stride 8, 16 and 32 maps (for a patch
    of 16), NCHW channels_last, in ``dtype``."""

    def __init__(self, img_size=1024, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, mlp_ratio=4, window_size=14,
                 global_blocks=(2, 5, 8, 11), pretrain_grid=14,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pretrain_grid ** 2 + 1, embed_dim))
        grid = img_size // patch_size
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_blocks else window_size, grid)
            for i in range(depth))
        self.simfp_3 = nn.Sequential(
            ConvTranspose2d(embed_dim, embed_dim // 2, 2, stride=2))
        self.out_channels = (embed_dim // 2, embed_dim, embed_dim)
        self._pos = (None, None)

    def abs_pos(self, h, w, dtype):
        """detectron2's ``get_abs_pos``: the table less its cls row,
        resized bicubically to h x w where its square differs, (1, h, w,
        C) in ``dtype``."""
        pe = self.pos_embed

        def make():
            grid = pe[:, 1:]
            size = math.isqrt(grid.shape[1])
            grid = grid.reshape(1, size, size, -1)
            if (size, size) != (h, w):
                grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(h, w),
                                     mode='bicubic', align_corners=False
                                     ).permute(0, 2, 3, 1)
            return grid.to(dtype)
        return _kept(self, '_pos', (h, w, dtype, pe.device, _version(pe)),
                     make)

    def forward(self, images):
        with span('backbone.vit.embed'):
            x = self.patch_embed(images.to(self.dtype).permute(0, 3, 1, 2))
            x = x + self.abs_pos(x.shape[1], x.shape[2], x.dtype)
        for block in self.blocks:
            x = block(x)
        with span('backbone.vit.pyramid'):
            mid = x.permute(0, 3, 1, 2)
            up = self.simfp_3(mid).contiguous(
                memory_format=torch.channels_last)
            return up, mid, F.max_pool2d(mid, 2, 2)
