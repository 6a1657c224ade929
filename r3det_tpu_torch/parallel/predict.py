"""Inference step: a batch of NHWC images in, padded detections out.

Port of ``r3det_tpu/parallel/mesh.py::make_predict_step`` on one device:
no mesh and no jit; the model carries its own weights. Under data
parallelism each rank runs its own step on its own images, and
``utils/eval_loop.py`` gathers the results (the mesh step's batch
sharding).
"""
import torch

from ..models.detectors import detector_predict
from ..utils.tracing import span


def make_predict_step(model, cfg, featmap_sizes, img_shape=None):
    """``step(images) -> (dets (B, max_per_img, 6), labels, num)``; NMS
    follows the detector's ``kernels`` switch. Spans (``utils/tracing.py``):
    ``predict`` around the step, ``forward`` around the model call."""
    @torch.no_grad()
    def step(images):
        with span('predict'):
            with span('forward'):
                out = model(images)
            return detector_predict(out, cfg, featmap_sizes,
                                    img_shape=img_shape,
                                    kernels=model.kernels)
    return step
