"""Rotated RetinaNet head.

Port of ``r3det_tpu/models/retina_head.py``: ``stacked_convs`` 3x3 conv +
ReLU on each of the cls and reg branches, then 3x3 prediction convs giving
``num_anchors * num_classes`` logits and ``num_anchors * 5`` deltas per
position. The cls bias starts at the focal prior -log((1 - p) / p),
p = 0.01. Outputs are f32 ``(B, H, W, A*C)`` / ``(B, H, W, A*5)``, the
anchor layout of ``core/anchors.py``. ``quantize`` makes the tower convs
``QConv``s; ``retina_cls`` and ``retina_reg`` stay float. A bf16
``quantize='static'`` head on a card runs each tower conv as one launch of
the int8 conv kernel with its ReLU fused, writing the next tower conv's
int8 codes (``RRetinaHead.fused_towers``).
"""
import math

import torch.nn.functional as F
from torch import nn

from ..ops import int8_conv
from .conv import Conv2d
from .quant import conv_factory


def focal_bias(prior=0.01):
    return -math.log((1 - prior) / prior)


class RRetinaHead(nn.Module):
    def __init__(self, num_classes=15, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=9, quantize=False):
        super().__init__()
        self.stacked_convs = stacked_convs
        conv = conv_factory(quantize)
        for branch in ('cls', 'reg'):
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                self.add_module(f'{branch}_conv_{i}',
                                conv(cin, feat_channels, 3, padding=1))
        cin = feat_channels if stacked_convs else in_channels
        self.retina_cls = Conv2d(cin, num_anchors * num_classes, 3, padding=1)
        self.retina_reg = Conv2d(cin, num_anchors * 5, 3, padding=1)
        nn.init.constant_(self.retina_cls.bias, focal_bias())
        self.quantize = quantize

    def fused_route(self, x):
        """Whether this call takes :meth:`fused_towers`: static int8
        towers, not calibrating, where the int8 conv kernel takes ``x``."""
        if self.quantize != 'static' or not self.stacked_convs:
            return False
        conv = self.cls_conv_0
        return not conv.calibrating and int8_conv.refusal(
            x, x.dtype, *conv.weight.shape[1::-1]) is None

    def fused_towers(self, x):
        """Both towers on one level with ``QConv.fused``: each conv applies
        its ReLU and writes the next tower conv's int8 codes; the last one
        writes bf16 for ``retina_cls`` / ``retina_reg``. The same ops, in
        the same order, as the unfused towers. Returns NCHW (cls, reg)."""
        out = []
        for branch in ('cls', 'reg'):
            y = x.permute(0, 2, 3, 1)                        # NHWC
            for i in range(self.stacked_convs):
                conv = getattr(self, f'{branch}_conv_{i}')
                last = i + 1 == self.stacked_convs
                y = conv.fused(y, relu=True, out_scale=None if last else
                               getattr(self, f'{branch}_conv_{i + 1}')
                               .act_scale())
            out.append(y.permute(0, 3, 1, 2))
        return tuple(out)

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            if self.fused_route(x):
                cf, rf = self.fused_towers(x)
            else:
                cf, rf = x, x
                for i in range(self.stacked_convs):
                    cf = F.relu(getattr(self, f'cls_conv_{i}')(cf))
                    rf = F.relu(getattr(self, f'reg_conv_{i}')(rf))
            # predictions in f32 for decode
            cls_scores.append(self.retina_cls(cf).float().permute(0, 2, 3, 1))
            bbox_preds.append(self.retina_reg(rf).float().permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds)
