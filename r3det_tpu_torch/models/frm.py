"""Feature Refinement Module (R3Det).

Port of ``r3det_tpu/models/frm.py`` (``feature_refine_sample``,
``FeatureRefineModule``): per level, a 1x5 -> 5x1 conv branch plus a 1x1
conv branch, bilinearly sampled at each position's best-box centre
(points=1) or centre + 4 corners (points=5), residual-added twice:
``x + (feat + sample)``. The reference's transposed-coordinate quirk is on
by default (row <- cx * scale, col <- cy * scale).

points=1 runs through :func:`..ops.frm_sample.frm_sample` (the K2 kernel on
bf16 CUDA tensors when ``kernels`` is on; an f32 model takes the plain
form, ``FeatureRefineModule.sample_route``). points=5 has the plain form
only, and raises on CUDA tensors until it has a kernel. ``quantize`` makes
the three branch convs ``QConv``s; the sample and the residual adds stay
in the input's dtype.
"""
import torch
from torch import nn

from ..ops.frm_sample import (bilinear_sample, frm_sample,
                              frm_sample_reference, sample_coords)
from .quant import conv_factory


def feature_refine_sample(feat, best_bboxes, spatial_scale, points=1,
                          transpose_quirk=True):
    """FR op of one level, plain form: feat (B, H, W, C), best_bboxes
    (B, H*W, 5) -> feat + the sum of bilinear samples at the box points."""
    b, h, w, c = feat.shape
    row0, col0 = sample_coords(best_bboxes, spatial_scale, transpose_quirk)
    acc = bilinear_sample(feat, row0, col0).reshape(b, h, w, c)
    if points == 5:
        cx = best_bboxes[..., 0] * spatial_scale
        cy = best_bboxes[..., 1] * spatial_scale
        bw = best_bboxes[..., 2] * spatial_scale
        bh = best_bboxes[..., 3] * spatial_scale
        a = best_bboxes[..., 4]
        cosa, sina = torch.cos(a), torch.sin(a)
        wx, wy = cosa * bw / 2, sina * bw / 2
        hx, hy = -sina * bh / 2, cosa * bh / 2
        # corner sign pairs on the (w, h) axis vectors, the reference's
        # p1..p4 order (feature_refine_kernel.cu:146-150)
        for sw, sh in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
            dx = sw * wx + sh * hx
            dy = sw * wy + sh * hy
            if transpose_quirk:
                r, cc = cx + dy, cy + dx
            else:
                r, cc = cy + dy, cx + dx
            acc = acc + bilinear_sample(feat, r, cc).reshape(b, h, w, c)
    elif points != 1:
        raise ValueError('points must be 1 or 5')
    return feat + acc


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
        """Whether the points=1 sample takes :func:`frm_sample` (K2): bf16
        features on a card, kernels on."""
        return self.kernels and feat.is_cuda and feat.dtype == torch.bfloat16

    def forward(self, feats, rois):
        assert len(feats) == len(self.featmap_strides)
        out = []
        for x, roi, stride in zip(feats, rois, self.featmap_strides):
            feat = self.conv_5_1(self.conv_1_5(x)) + self.conv_1_1(x)
            xs = x.permute(0, 2, 3, 1)                 # NHWC views
            fs = feat.permute(0, 2, 3, 1)
            scale = 1.0 / stride
            if self.points == 1:
                fn = frm_sample if self.sample_route(fs) else \
                    frm_sample_reference
                y = fn(xs.contiguous(), fs.contiguous(), roi.contiguous(),
                       scale, self.transpose_quirk)
            elif x.is_cuda:
                raise NotImplementedError(
                    'FRM points=5 has no CUDA kernel yet')
            else:
                y = xs + feature_refine_sample(fs, roi, scale, self.points,
                                               self.transpose_quirk)
            out.append(y.permute(0, 3, 1, 2))
        return tuple(out)
