"""Feature Refinement Module (R3Det).

Port of ``r3det_tpu/models/frm.py::FeatureRefineModule`` (its
``feature_refine_sample`` is ``ops/frm_sample.py``'s): per level, a 1x5 ->
5x1 conv branch plus a 1x1 conv branch, bilinearly sampled at each
position's best-box centre (points=1) or centre + 4 corners (points=5),
residual-added twice: ``x + (feat + sample)``. The reference's
transposed-coordinate quirk is on by default (row <- cx * scale, col <-
cy * scale).

Every level of a stage runs through one
:func:`..ops.frm_sample.frm_sample_levels` call, points 1 and 5: one
launch of the K2 kernel on bf16 CUDA tensors when ``kernels`` is on, and
under autograd one launch of K2's backward kernel
(``ops/frm_sample.py::FRMSampleLevels``); an f32 model, or ``kernels``
off, takes the plain form, autograd through
``frm_sample_levels_reference`` (``FeatureRefineModule.sample_route``).
``quantize`` makes the three branch convs ``QConv``s; the sample and the
residual adds stay in the input's dtype.
"""
import torch
from torch import nn

from ..ops.frm_sample import frm_sample_levels, frm_sample_levels_reference
from .quant import conv_factory


class FeatureRefineModule(nn.Module):
    """forward(feats, rois): feats NCHW channels_last levels, rois[lvl]
    (B, H*W, 5) f32 best boxes in image coordinates."""

    def __init__(self, in_channels=256, featmap_strides=(8, 16, 32, 64, 128),
                 points=1, transpose_quirk=True, kernels=True,
                 quantize=False):
        super().__init__()
        if points not in (1, 5):
            raise ValueError('points must be 1 or 5')
        self.featmap_strides = tuple(featmap_strides)
        self.points = points
        self.transpose_quirk = transpose_quirk
        self.kernels = kernels
        c = in_channels
        conv = conv_factory(quantize)
        self.conv_5_1 = conv(c, c, (5, 1), padding=(2, 0))
        self.conv_1_5 = conv(c, c, (1, 5), padding=(0, 2))
        self.conv_1_1 = conv(c, c, 1)

    def sample_route(self, feat):
        """Whether the sample (points 1 and 5) takes
        :func:`frm_sample_levels` (K2): bf16 features on a card, kernels
        on."""
        return self.kernels and feat.is_cuda and feat.dtype == torch.bfloat16

    def forward(self, feats, rois):
        assert len(feats) == len(self.featmap_strides)
        xs, fs = [], []
        for x in feats:
            feat = self.conv_5_1(self.conv_1_5(x)) + self.conv_1_1(x)
            xs.append(x.permute(0, 2, 3, 1).contiguous())    # NHWC views
            fs.append(feat.permute(0, 2, 3, 1).contiguous())
        fn = frm_sample_levels if self.sample_route(fs[0]) else \
            frm_sample_levels_reference
        ys = fn(xs, fs, [r.contiguous() for r in rois],
                [1.0 / s for s in self.featmap_strides], self.points,
                self.transpose_quirk)
        return tuple(y.permute(0, 3, 1, 2) for y in ys)
