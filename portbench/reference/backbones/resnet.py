"""The ``resnet`` backbone of the reference: ResNet with frozen BN and the
program's folded stem (``reference/model.py``'s docstring), C2-C5 out.

Sizes from the configuration: ``backbone_depth`` and ``frozen_stages``.
No ``seed_rule``: ``common.seeded_state``'s shared rule draws every conv
and sets FrozenBN.
"""
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import FrozenBN, conv, fake_quant

STAGE_BLOCKS = {10: (1, 1, 1, 1), 14: (2, 1, 1, 1), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}
WIDTHS = (64, 128, 256, 512)


def build(cfg):
    return ResNet(cfg['backbone_depth'], cfg['frozen_stages'])


class Bottleneck(nn.Module):
    def __init__(self, cin, f, stride):
        super().__init__()
        self.conv1 = conv(cin, f, 1, bias=False)
        self.bn1 = FrozenBN(f)
        self.conv2 = conv(f, f, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(f)
        self.conv3 = conv(f, 4 * f, 1, bias=False)
        self.bn3 = FrozenBN(4 * f)
        self.has_downsample = cin != 4 * f or stride != 1
        if self.has_downsample:
            self.downsample_conv = conv(cin, 4 * f, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(4 * f)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = self.downsample_bn(self.downsample_conv(x)) \
            if self.has_downsample else x
        return F.relu(y + res)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(4, 4, 12, 64))


class ResNet(nn.Module):
    out_channels = tuple(4 * f for f in WIDTHS)

    def __init__(self, depth=50, frozen_stages=1):
        super().__init__()
        self.depth = depth
        self.frozen_stages = frozen_stages
        self.conv1 = _Stem()
        self.bn1 = FrozenBN(64)
        cin = 64
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            for b in range(n):
                stride = 2 if b == 0 and s > 0 else 1
                self.add_module(f'layer{s + 1}_{b}',
                                Bottleneck(cin, WIDTHS[s], stride))
                cin = 4 * WIDTHS[s]

    def stem(self, images):
        b, h, w, c = images.shape
        x = images.reshape(b, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
        w = self.conv1.kernel.permute(3, 2, 0, 1)
        x = F.pad(x, (2, 1, 2, 1))
        q = getattr(self, 'quant', None)
        if q:
            x, w = fake_quant(x, q), fake_quant(w, q, 0)
        x = F.conv2d(x, w)
        if q:
            x = fake_quant(x, q)
        x = F.relu(self.bn1(x))
        y = F.max_pool2d(x, 3, stride=2, padding=1)
        return y[:, :, :x.shape[2] // 2, :x.shape[3] // 2]

    def forward(self, images):
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.frozen_stages < 0):
            x = self.stem(images)
        outs = []
        for s, n in enumerate(STAGE_BLOCKS[self.depth]):
            with torch.set_grad_enabled(grad and s >= self.frozen_stages):
                for b in range(n):
                    x = getattr(self, f'layer{s + 1}_{b}')(x)
            outs.append(x)
        return outs
