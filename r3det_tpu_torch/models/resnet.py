"""ResNet backbone (C2..C5), inference only.

Port of ``r3det_tpu/models/resnet.py`` (``FrozenBN``, the plain
``Bottleneck``, ``space_to_depth_2x``, ``ResNet`` with the folded
space-to-depth stem). Depths 10, 14 and 50. Activations are NCHW tensors
in ``torch.channels_last`` memory, i.e. NHWC bytes; the public input is the
NHWC image. Parameters stay f32 and every layer computes in its input's
dtype (``dtype`` for the whole trunk), as the flax modules do.

The stem keeps the JAX package's folded ``(4, 4, 12, 64)`` HWIO kernel
(``conv1.kernel``) and runs through :mod:`..ops.stem_pool` (the K3 kernel
on CUDA tensors when ``kernels`` is on).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem_pool import stem_conv_pool, stem_conv_pool_reference
from .conv import Conv2d

STAGE_BLOCKS = {10: (1, 1, 1, 1), 14: (2, 1, 1, 1), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
WIDTHS = (64, 128, 256, 512)


class FrozenBN(nn.Module):
    """Affine-only BatchNorm: y = x * inv + b with inv and b computed in f32
    from the (frozen) statistics, then cast to the input's dtype."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        r = torch.rsqrt(self.var + self.eps)
        inv = (self.scale * r).to(x.dtype)
        b = (self.bias - self.mean * self.scale * r).to(x.dtype)
        return x * inv.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck ('pytorch' style), out = 4F."""

    def __init__(self, inplanes, features, stride=1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, features, 1, bias=False)
        self.bn1 = FrozenBN(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBN(features)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBN(features * 4)
        self.has_downsample = inplanes != features * 4 or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(inplanes, features * 4, 1,
                                          stride=stride, bias=False)
            self.downsample_bn = FrozenBN(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


def space_to_depth_2x(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), packing 2x2 blocks in (dy, dx, c)
    channel order (the stem kernel's fold depends on it)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class _StemConv(nn.Module):
    """Holds the folded stem kernel under the flax name ``conv1/kernel``."""

    def __init__(self):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(4, 4, 12, 64))


class ResNet(nn.Module):
    """ResNet trunk: NHWC image (B, H, W, 3) -> (C2, C3, C4, C5), NCHW
    channels_last, in ``dtype``."""

    def __init__(self, depth=50, dtype=torch.float32, kernels=True):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.kernels = kernels
        self.conv1 = _StemConv()
        self.bn1 = FrozenBN(64)
        inplanes = 64
        for stage, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            for blk in range(num_blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                self.add_module(f'layer{stage + 1}_{blk}',
                                Bottleneck(inplanes, WIDTHS[stage], stride))
                inplanes = WIDTHS[stage] * 4

    def stem_affine(self):
        """Folded FrozenBN of the stem (f32): ``(inv, off)``."""
        inv = self.bn1.scale * torch.rsqrt(self.bn1.var + 1e-5)
        return inv, self.bn1.bias - self.bn1.mean * inv

    def forward(self, images):
        x = space_to_depth_2x(images.to(self.dtype))
        inv, off = self.stem_affine()
        stem = stem_conv_pool if self.kernels else stem_conv_pool_reference
        x = stem(x, self.conv1.kernel, inv, off, dtype=self.dtype)
        x = x.permute(0, 3, 1, 2)                    # NCHW, channels_last
        outs = []
        for stage, num_blocks in enumerate(STAGE_BLOCKS[self.depth]):
            for blk in range(num_blocks):
                x = getattr(self, f'layer{stage + 1}_{blk}')(x)
            outs.append(x)
        return tuple(outs)
