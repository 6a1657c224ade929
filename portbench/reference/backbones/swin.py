"""The ``swin`` backbone of the reference: mmdet 2.x's ``SwinTransformer``
(``mmdet/models/backbones/swin.py``, with ``PatchEmbed`` and
``PatchMerging`` of ``mmdet/models/utils/transformer.py``) in plain
float32 ``torch``, token-major ``(B, L, C)`` as mmdet computes it.

Sizes from the configuration: ``swin_embed_dims``, ``swin_depths``,
``swin_num_heads``, ``swin_window_size``, ``swin_mlp_ratio``,
``swin_patch_size``, ``swin_out_indices``. Always as mmdet's Swin-T
config builds it: qkv bias, no ``qk_scale``, patch norm, no absolute
position embedding, strides (patch, 2, 2, 2), mmcv's GELU and LayerNorm
(eps 1e-5). Drop-path and dropout are inert at inference and left out.

What mmdet does that the code below keeps step by step: 'corner' padding
of the image to a multiple of the patch and of each merge's input to
even sides; each block's map zero-padded after ``norm1`` to a multiple of
the window, unmasked; on odd blocks the roll by ``-window // 2``, the mask
of nine regions (``h_slices`` x ``w_slices`` on the padded map) at -100,
the roll back; the bias index by ``double_step_seq``; the merge's 2x2
neighbourhoods by ``nn.Unfold`` (channel-major order).

A ``Linear`` (and the patch conv, ``model.Conv``) with ``quant`` set
rounds its input, its output (per tensor) and its weight (per output
channel) to that precision: the control one precision below
(``check.quantized``).

``seed_rule``: linears normal(0, fan_in^-1/2), the bias tables normal(0,
1), LayerNorm gains 1; biases 0 and the patch conv by the shared rule
(``common.seeded_state``). mmdet's trunc_normal(0.02) would make each
block's branch a few percent of the residual stream, and the check could
not see a fault in one block, mask or index.
"""
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import conv, fake_quant


def build(cfg):
    return SwinTransformer(
        cfg['swin_embed_dims'], cfg['swin_depths'], cfg['swin_num_heads'],
        cfg['swin_window_size'], cfg['swin_mlp_ratio'],
        cfg['swin_patch_size'], cfg['swin_out_indices'])


def seed_rule(name, shape):
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'relative_position_bias_table':
        return ('normal', 1.0)
    if leaf == 'weight' and len(shape) == 2:
        return ('normal', shape[1] ** -0.5)
    if leaf == 'weight' and len(shape) == 1:
        return ('fill', 1.0)
    return None


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        if self.quant:
            y = F.linear(fake_quant(x, self.quant),
                         fake_quant(self.weight, self.quant, 0), self.bias)
            return fake_quant(y, self.quant)
        return super().forward(x)


def corner_pad(x, kernel, stride):
    """mmdet's ``AdaptivePadding(padding='corner')`` of an NCHW map."""
    h, w = x.shape[-2:]
    ph = max((-(-h // stride) - 1) * stride + kernel - h, 0)
    pw = max((-(-w // stride) - 1) * stride + kernel - w, 0)
    return F.pad(x, [0, pw, 0, ph]) if ph or pw else x


class WindowMSA(nn.Module):
    def __init__(self, embed_dims, num_heads, window_size):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (embed_dims // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        ws = window_size
        coords = self.double_step_seq(2 * ws - 1, ws, 1, ws)
        index = (coords + coords.T).flip(1).contiguous()
        self.register_buffer('relative_position_index', index)
        self.qkv = Linear(embed_dims, embed_dims * 3)
        self.proj = Linear(embed_dims, embed_dims)

    def forward(self, x, mask=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.num_heads, n, n) \
                + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)

    @staticmethod
    def double_step_seq(step1, len1, step2, len2):
        seq1 = torch.arange(0, step1 * len1, step1)
        seq2 = torch.arange(0, step2 * len2, step2)
        return (seq1[:, None] + seq2[None, :]).reshape(1, -1)


class ShiftWindowMSA(nn.Module):
    def __init__(self, embed_dims, num_heads, window_size, shift_size):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size)

    def forward(self, query, hw_shape):
        b, length, c = query.shape
        h, w = hw_shape
        ws, s = self.window_size, self.shift_size
        query = query.view(b, h, w, c)
        pad_r = (ws - w % ws) % ws
        pad_b = (ws - h % ws) % ws
        query = F.pad(query, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = query.shape[1], query.shape[2]
        if s > 0:
            shifted = torch.roll(query, shifts=(-s, -s), dims=(1, 2))
            img_mask = torch.zeros((1, hp, wp, 1), device=query.device)
            slices = (slice(0, -ws), slice(-ws, -s), slice(-s, None))
            cnt = 0
            for hs in slices:
                for wsl in slices:
                    img_mask[:, hs, wsl, :] = cnt
                    cnt += 1
            mask_windows = self.window_partition(img_mask).view(-1, ws * ws)
            attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
            attn_mask = attn_mask.masked_fill(attn_mask != 0, -100.0) \
                .masked_fill(attn_mask == 0, 0.0)
        else:
            shifted, attn_mask = query, None
        windows = self.window_partition(shifted).view(-1, ws * ws, c)
        windows = self.w_msa(windows, mask=attn_mask).view(-1, ws, ws, c)
        x = self.window_reverse(windows, hp, wp)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        return x[:, :h, :w, :].contiguous().view(b, h * w, c)

    def window_partition(self, x):
        b, h, w, c = x.shape
        ws = self.window_size
        x = x.view(b, h // ws, ws, w // ws, ws, c)
        return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)

    def window_reverse(self, windows, h, w):
        ws = self.window_size
        b = int(windows.shape[0] / (h * w / ws / ws))
        x = windows.view(b, h // ws, w // ws, ws, ws, -1)
        return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


class FFN(nn.Module):
    def __init__(self, embed_dims, hidden):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, hidden), nn.GELU()),
            Linear(hidden, embed_dims))

    def forward(self, x, identity):
        return identity + self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, embed_dims, num_heads, hidden, window_size, shift):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dims)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   window_size // 2 if shift else 0)
        self.norm2 = nn.LayerNorm(embed_dims)
        self.ffn = FFN(embed_dims, hidden)

    def forward(self, x, hw_shape):
        x = self.attn(self.norm1(x), hw_shape) + x
        return self.ffn(self.norm2(x), identity=x)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dims, patch_size):
        super().__init__()
        self.patch_size = patch_size
        self.projection = conv(3, embed_dims, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dims)

    def forward(self, x):
        x = corner_pad(x, self.patch_size, self.patch_size)
        x = self.projection(x)
        out_size = (x.shape[2], x.shape[3])
        return self.norm(x.flatten(2).transpose(1, 2)), out_size


class PatchMerging(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.sampler = nn.Unfold(kernel_size=2, stride=2)
        self.norm = nn.LayerNorm(4 * in_channels)
        self.reduction = Linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x, input_size):
        b, length, c = x.shape
        h, w = input_size
        x = corner_pad(x.view(b, h, w, c).permute(0, 3, 1, 2), 2, 2)
        h, w = x.shape[-2:]
        x = self.sampler(x).transpose(1, 2)
        return self.reduction(self.norm(x)), (h // 2, w // 2)


class SwinBlockSequence(nn.Module):
    def __init__(self, embed_dims, num_heads, hidden, depth, window_size,
                 downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(embed_dims, num_heads, hidden, window_size, i % 2 == 1)
            for i in range(depth))
        self.downsample = downsample

    def forward(self, x, hw_shape):
        for block in self.blocks:
            x = block(x, hw_shape)
        if self.downsample:
            x_down, down_hw = self.downsample(x, hw_shape)
            return x_down, down_hw, x, hw_shape
        return x, hw_shape, x, hw_shape


class SwinTransformer(nn.Module):
    """NHWC images -> the ``out_indices`` stages' NCHW float32 maps."""

    def __init__(self, embed_dims, depths, num_heads, window_size,
                 mlp_ratio, patch_size, out_indices):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dims, patch_size)
        self.stages = nn.ModuleList()
        c = embed_dims
        for i, depth in enumerate(depths):
            down = PatchMerging(c, 2 * c) if i < len(depths) - 1 else None
            self.stages.append(SwinBlockSequence(
                c, num_heads[i], mlp_ratio * c, depth, window_size, down))
            if down:
                c *= 2
        self.num_features = [embed_dims * 2 ** i for i in range(len(depths))]
        for i in self.out_indices:
            self.add_module(f'norm{i}', nn.LayerNorm(self.num_features[i]))
        self.out_channels = tuple(self.num_features[i]
                                  for i in self.out_indices)

    def forward(self, images):
        x, hw_shape = self.patch_embed(images.permute(0, 3, 1, 2).float())
        outs = []
        for i, stage in enumerate(self.stages):
            x, hw_shape, out, out_hw = stage(x, hw_shape)
            if i in self.out_indices:
                out = getattr(self, f'norm{i}')(out)
                outs.append(out.view(-1, *out_hw, self.num_features[i])
                            .permute(0, 3, 1, 2).contiguous())
        return outs
