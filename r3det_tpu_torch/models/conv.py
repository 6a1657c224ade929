"""Convolution that computes in its input's dtype.

flax's ``nn.Conv(dtype=...)`` keeps f32 parameters and casts kernel and
bias to the compute dtype at the call; this ``nn.Conv2d`` does the same, so
one f32 state dict serves an f32 and a bf16 model. Weight layout is torch's
OIHW; ``utils/convert.py`` maps flax's HWIO kernels onto it.
"""
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)
