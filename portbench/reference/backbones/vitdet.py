"""The ``vitdet`` backbone of the reference: ViTDet's plain ViT (Li, Mao,
Girshick, He, ECCV 2022, arXiv:2203.16527; detectron2's
``modeling/backbone/vit.py``: ``ViT``, ``Block``, ``Attention``,
``get_abs_pos``, ``get_rel_pos``, ``add_decomposed_rel_pos``,
``window_partition``, ``window_unpartition``) in plain float32 ``torch``,
token-grid (B, H, W, C) as detectron2 computes it, under its names, and
three levels of its ``SimpleFeaturePyramid`` (scale factors 2, 1, 0.5).

Sizes from the configuration: ``vit_img_size``, ``vit_patch_size``,
``vit_embed_dim``, ``vit_depth``, ``vit_num_heads``, ``vit_mlp_ratio``,
``vit_window_size``, ``vit_global_blocks`` (the blocks not in
``window_block_indexes``), ``vit_pretrain_grid`` (``pretrain_img_size //
patch_size``). Always as ViTDet's ViT-B builds it: qkv bias, absolute
position embedding with a cls row, ``use_rel_pos``, LayerNorm eps 1e-6,
exact GELU, no residual conv blocks. Drop-path is inert at inference and
left out.

    x = patch_embed(image) + get_abs_pos(pos_embed)
    each block:  x = x + Attn(norm1(x))       (windows: pad, partition,
                 x = x + fc2(GELU(fc1(norm2(x))))   attend, unpartition)
    Attn logits: d^-1/2 q_i.k_j + q_i.Rh[i_h - j_h + Hq - 1]
                                + q_i.Rw[i_w - j_w + Wq - 1]   (unscaled q)
    out:         simfp_3.0 (ConvTranspose2d 2x2/s2) of x, x, MaxPool2d(2)

A window block's pad is not masked. The attention is written out: the
logits, the two relative terms, the softmax and P.v, with no fused
kernel; a global block's batch is computed a few images at a time, so
that its logits fit in float32.

Every ``Linear``, the patch conv (``model.Conv``) and the transposed conv
with ``quant`` set round their input, their output (per tensor) and their
weight (per output channel) to that precision: the control one precision
below (``check.quantized``).

``seed_rule``: every linear's and conv's weight and bias normal(0,
fan_in^-1/2) (the transposed conv's fan-in is its input channels: with
kernel = stride each output takes one tap of each); LayerNorm gains 1 and
biases 0; ``pos_embed`` normal(0, 0.02); ``rel_pos_h`` and ``rel_pos_w``
normal(0, 0.1), where the source starts them at zero. A zero table would
hide a program that left a relative term out, and zero biases would make
an unmasked pad's keys those of a zero row.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import Conv, fake_quant

# the largest logits a chunk of the batch holds (float32 entries)
CHUNK_ENTRIES = 1 << 28

# a layer's fan-in, noted at its weight and read at its bias (the state
# dict gives each weight before its bias)
_FAN_IN = {}


def build(cfg):
    return ViT(cfg['vit_img_size'], cfg['vit_patch_size'],
               cfg['vit_embed_dim'], cfg['vit_depth'], cfg['vit_num_heads'],
               cfg['vit_mlp_ratio'], cfg['vit_window_size'],
               cfg['vit_global_blocks'], cfg['vit_pretrain_grid'])


def seed_rule(name, shape):
    module, _, leaf = name.rpartition('.')
    if leaf == 'pos_embed':
        return ('normal', 0.02)
    if leaf in ('rel_pos_h', 'rel_pos_w'):
        return ('normal', 0.1)
    if leaf == 'weight' and len(shape) == 1:            # LayerNorm
        return ('fill', 1.0)
    if leaf == 'weight':
        fan = shape[0] if module.startswith('simfp_') \
            else math.prod(shape[1:])
        _FAN_IN[module] = fan
        return ('normal', fan ** -0.5)
    if leaf == 'bias' and module in _FAN_IN:
        return ('normal', _FAN_IN.pop(module) ** -0.5)
    return None                                          # LayerNorm biases


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        if self.quant:
            y = F.linear(fake_quant(x, self.quant),
                         fake_quant(self.weight, self.quant, 0), self.bias)
            return fake_quant(y, self.quant)
        return super().forward(x)


class ConvTranspose(nn.ConvTranspose2d):
    quant = None

    def forward(self, x):
        if self.quant:
            y = F.conv_transpose2d(fake_quant(x, self.quant),
                                   fake_quant(self.weight, self.quant, 1),
                                   self.bias, self.stride)
            return fake_quant(y, self.quant)
        return super().forward(x)


def get_abs_pos(abs_pos, hw):
    h, w = hw
    abs_pos = abs_pos[:, 1:]                             # the cls row
    size = int(math.sqrt(abs_pos.shape[1]))
    if size != h or size != w:
        new = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w), mode='bicubic', align_corners=False)
        return new.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode='linear')
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size,
                                                          1.0)
    return resized[relative.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum('bhwc,hkc->bhwk', r_q, rh)
    rel_w = torch.einsum('bhwc,wkc->bhwk', r_q, rw)
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(b, q_h * q_w, k_h * k_w)


def window_partition(x, window_size):
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size,
               window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.view(b, hp // window_size, wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x):
        b, h, w, _ = x.shape
        n = h * w
        chunk = max(1, CHUNK_ENTRIES // (self.num_heads * n * n))
        return torch.cat([self.attend(x[i:i + chunk])
                          for i in range(0, b, chunk)])

    def attend(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.num_heads, h * w, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                      self.rel_pos_w, (h, w), (h, w))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(b, self.num_heads, h, w, -1) \
            .permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, input_size if window_size == 0
                              else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = Conv(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)          # B C H W -> B H W C


class ViT(nn.Module):
    """NHWC images -> the stride 8, 16 and 32 NCHW float32 maps (a patch of
    16)."""

    def __init__(self, img_size, patch_size, embed_dim, depth, num_heads,
                 mlp_ratio, window_size, global_blocks, pretrain_grid):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1,
                                                  embed_dim))
        grid = img_size // patch_size
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_blocks else window_size, (grid, grid))
            for i in range(depth))
        self.simfp_3 = nn.Sequential(
            ConvTranspose(embed_dim, embed_dim // 2, 2, stride=2))
        self.out_channels = (embed_dim // 2, embed_dim, embed_dim)

    def forward(self, images):
        x = self.patch_embed(images.permute(0, 3, 1, 2).float())
        x = x + get_abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        mid = x.permute(0, 3, 1, 2).contiguous()
        return [self.simfp_3(mid), mid, F.max_pool2d(mid, 2, 2)]
