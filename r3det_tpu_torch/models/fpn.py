"""Feature Pyramid Network, P3..P7.

Port of ``r3det_tpu/models/fpn.py`` (mmdet's FPN as the reference
configures it: out 256, add_extra_convs 'on_input', num_outs 5) on the
backbone's last three outputs: ResNet's C3-C5 of (256, 512, 1024, 2048)
(start_level 1), Swin-T's three of (192, 384, 768) (start_level 0),
LSKNet-S's last three of (64, 128, 320, 512) (start_level 1).
Nearest 2x top-down upsampling cropped to the lateral's size; the extra
levels P6, P7 are strided 3x3 convs on the last input, with ReLU before
the second. ``quantize`` makes every conv (laterals, outputs, extras) a
``QConv``.
"""
import torch.nn.functional as F
from torch import nn

from .quant import conv_factory


def _upsample_nearest_2x(x, target_hw):
    th, tw = target_hw
    return F.interpolate(x, scale_factor=2.0, mode='nearest')[:, :, :th, :tw]


NUM_INS = 3
NUM_EXTRA = 2


class FPN(nn.Module):
    """forward(backbone outputs) -> (P3, P4, P5, P6, P7), laterals on the
    last ``NUM_INS`` of them; ``in_channels`` are the backbone's
    ``out_channels``."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 quantize=False):
        super().__init__()
        conv = conv_factory(quantize)
        used = list(in_channels[-NUM_INS:])
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
        used = list(feats[-NUM_INS:])
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
