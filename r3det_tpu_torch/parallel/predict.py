"""Inference step: a batch of NHWC images in, padded detections out.

Port of ``r3det_tpu/parallel/mesh.py::make_predict_step`` for one device:
no mesh and no jit; the model carries its own weights.
"""
import torch

from ..models.detectors import detector_predict


def make_predict_step(model, cfg, featmap_sizes, img_shape=None):
    """``step(images) -> (dets (B, max_per_img, 6), labels, num)``; NMS
    follows the model's ``kernels`` switch."""
    @torch.no_grad()
    def step(images, return_branch=False):
        out = model(images)
        return detector_predict(out, cfg, featmap_sizes, img_shape=img_shape,
                                return_branch=return_branch,
                                kernels=model.kernels)
    return step
