"""Feature Pyramid Network, P3..P7.

Port of ``r3det_tpu/models/fpn.py`` (mmdet's FPN as the reference
configures it, the only way it is built: in [256, 512, 1024, 2048], out
256, start_level 1, add_extra_convs 'on_input', num_outs 5). Nearest 2x
top-down upsampling cropped to the lateral's size; the extra levels
P6, P7 are strided 3x3 convs on C5, with ReLU before the second.
``quantize`` makes every conv (laterals, outputs, extras) a ``QConv``.
"""
import torch.nn.functional as F
from torch import nn

from .quant import conv_factory


def _upsample_nearest_2x(x, target_hw):
    th, tw = target_hw
    return F.interpolate(x, scale_factor=2.0, mode='nearest')[:, :, :th, :tw]


START_LEVEL = 1
NUM_EXTRA = 2


class FPN(nn.Module):
    """forward((C2, C3, C4, C5)) -> (P3, P4, P5, P6, P7)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 quantize=False):
        super().__init__()
        conv = conv_factory(quantize)
        used = list(in_channels[START_LEVEL:])
        self.num_ins = len(used)
        for i, c in enumerate(used):
            self.add_module(f'lateral_{i}', conv(c, out_channels, 1))
            self.add_module(f'fpn_{i}', conv(out_channels, out_channels, 3,
                                             padding=1))
        for i in range(NUM_EXTRA):
            cin = in_channels[-1] if i == 0 else out_channels
            self.add_module(f'extra_{i}', conv(cin, out_channels, 3,
                                               stride=2, padding=1))

    def forward(self, feats):
        used = list(feats[START_LEVEL:])
        n = self.num_ins
        laterals = [getattr(self, f'lateral_{i}')(used[i]) for i in range(n)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[2:4])
        outs = [getattr(self, f'fpn_{i}')(laterals[i]) for i in range(n)]
        src = feats[-1]
        for i in range(NUM_EXTRA):
            src = getattr(self, f'extra_{i}')(F.relu(src) if i > 0 else src)
            outs.append(src)
        return tuple(outs)
