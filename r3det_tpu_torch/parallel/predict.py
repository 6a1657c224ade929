"""Inference step: a batch of NHWC images in, padded detections out.

Port of ``r3det_tpu/parallel/mesh.py::make_predict_step`` on one device:
no mesh and no jit; the model carries its own weights. Under data
parallelism each rank runs its own step on its own images, and
``utils/eval_loop.py`` gathers the results (the mesh step's batch
sharding).
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
