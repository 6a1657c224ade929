"""The ``lsknet`` backbone of the reference: LSKNet (Li et al., "Large
Selective Kernel Network for Remote Sensing Object Detection", ICCV 2023,
arXiv:2303.09030; ``mmrotate/models/backbones/lsknet.py`` of
github.com/zcablii/LSKNet) in plain float32 ``torch``, NCHW as the source
computes it, under its module and parameter names.

Sizes from the configuration: ``lsk_embed_dims``, ``lsk_depths``,
``lsk_mlp_ratios`` (LSKNet-S: 64-128-320-512, 2-2-4-2, 8-8-4-4). Each
stage: ``patch_embed{i}`` (a 7x7/s4 conv, pad 3, on the image for the
first stage, a 3x3/s2 conv, pad 1, after; then BN), its blocks
``block{i}.{j}`` and the LayerNorm over channels ``norm{i}`` (eps 1e-6),
whose output is the stage's and the next stage's input. A block:

    x = x + layer_scale_1 * Attn(norm1(x))
    x = x + layer_scale_2 * MLP(norm2(x))
    Attn(u) = proj_2(LSK(GELU(proj_1(u)))) + u
    MLP(u) = fc2(GELU(dwconv(fc1(u))))

and ``LSK`` (``attn.spatial_gating_unit``): a depthwise 5x5 conv, then a
depthwise 7x7 conv of dilation 3 on it, each squeezed to C/2 by a 1x1
conv; the channel mean and max of both, a dense 7x7 conv of 2 -> 2
channels and a sigmoid give one weight of each branch a position; the
weighted sum, a 1x1 conv back to C, multiplies the input. Every conv has
a bias, GELU is exact, BN (SyncBN in the source) computes with its
running statistics (eps 1e-5). Drop-path and dropout are inert at
inference and left out.

Every conv is a ``model.Conv``: with ``quant`` set it rounds its input,
its output (per tensor) and its weight (per output channel) to that
precision, the control one precision below (``check.quantized``).

``seed_rule``: convs normal(0, fan_in^-1/2) by the shared rule; LayerNorm
gains 1 and biases 0; layer scales 1.0 (the source starts them at 1e-2);
each BN's gain and running mean normal(0, 1), its bias normal(0, 0.5)
and its running variance 2.0. At 1e-2, or with identity BNs, ``err.fpn``
could not see a branch or a BN that a program left out.
"""
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import Conv

BN_RULE = {'weight': ('normal', 1.0), 'bias': ('normal', 0.5),
           'running_mean': ('normal', 1.0), 'running_var': ('fill', 2.0)}


def conv(cin, cout, k, stride=1, padding=0, groups=1, dilation=1):
    return Conv(cin, cout, k, stride=stride, padding=padding,
                dilation=dilation, groups=groups)


def build(cfg):
    return LSKNet(cfg['lsk_embed_dims'], cfg['lsk_depths'],
                  cfg['lsk_mlp_ratios'])


def seed_rule(name, shape):
    parts = name.split('.')
    leaf = parts[-1]
    if leaf.startswith('layer_scale_'):
        return ('fill', 1.0)
    if len(parts) == 2 and parts[0].startswith('norm'):     # LayerNorm
        return ('fill', 1.0) if leaf == 'weight' else None
    if parts[-2] in ('norm', 'norm1', 'norm2'):              # BN
        return BN_RULE.get(leaf)
    return None


class BatchNorm(nn.Module):
    """BN with its running statistics, under ``nn.BatchNorm2d``'s names."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        def v(t):
            return t.view(1, -1, 1, 1)
        return (x - v(self.running_mean)) / torch.sqrt(
            v(self.running_var) + self.eps) * v(self.weight) + v(self.bias)


class LSKblock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv0 = conv(dim, dim, 5, padding=2, groups=dim)
        self.conv_spatial = conv(dim, dim, 7, padding=9, groups=dim,
                                 dilation=3)
        self.conv1 = conv(dim, dim // 2, 1)
        self.conv2 = conv(dim, dim // 2, 1)
        self.conv_squeeze = conv(2, 2, 7, padding=3)
        self.conv = conv(dim // 2, dim, 1)

    def forward(self, x):
        attn1 = self.conv0(x)
        attn2 = self.conv_spatial(attn1)
        attn1 = self.conv1(attn1)
        attn2 = self.conv2(attn2)
        attn = torch.cat([attn1, attn2], dim=1)
        avg_attn = torch.mean(attn, dim=1, keepdim=True)
        max_attn, _ = torch.max(attn, dim=1, keepdim=True)
        agg = torch.cat([avg_attn, max_attn], dim=1)
        sig = self.conv_squeeze(agg).sigmoid()
        attn = attn1 * sig[:, 0:1] + attn2 * sig[:, 1:2]
        return x * self.conv(attn)


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj_1 = conv(dim, dim, 1)
        self.spatial_gating_unit = LSKblock(dim)
        self.proj_2 = conv(dim, dim, 1)

    def forward(self, x):
        shortcut = x
        x = self.proj_2(self.spatial_gating_unit(F.gelu(self.proj_1(x))))
        return x + shortcut


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = conv(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = conv(dim, hidden, 1)
        self.dwconv = DWConv(hidden)
        self.fc2 = conv(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class Block(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = BatchNorm(dim)
        self.attn = Attention(dim)
        self.norm2 = BatchNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.ones(dim))
        self.layer_scale_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        def v(t):
            return t.view(1, -1, 1, 1)
        x = x + v(self.layer_scale_1) * self.attn(self.norm1(x))
        return x + v(self.layer_scale_2) * self.mlp(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch, stride):
        super().__init__()
        self.proj = conv(cin, dim, patch, stride=stride, padding=patch // 2)
        self.norm = BatchNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class LSKNet(nn.Module):
    """NHWC images -> every stage's NCHW float32 map."""

    def __init__(self, embed_dims, depths, mlp_ratios):
        super().__init__()
        self.num_stages = len(depths)
        cin = 3
        for i, (dim, depth, ratio) in enumerate(zip(embed_dims, depths,
                                                    mlp_ratios)):
            setattr(self, f'patch_embed{i + 1}', OverlapPatchEmbed(
                cin, dim, 7 if i == 0 else 3, 4 if i == 0 else 2))
            setattr(self, f'block{i + 1}', nn.ModuleList(
                Block(dim, ratio) for _ in range(depth)))
            setattr(self, f'norm{i + 1}', nn.LayerNorm(dim, eps=1e-6))
            cin = dim
        self.out_channels = tuple(embed_dims)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).float()
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'patch_embed{i + 1}')(x)
            for blk in getattr(self, f'block{i + 1}'):
                x = blk(x)
            b, c, h, w = x.shape
            x = getattr(self, f'norm{i + 1}')(x.flatten(2).transpose(1, 2))
            x = x.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
            outs.append(x)
        return outs
