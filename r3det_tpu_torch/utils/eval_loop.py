"""Dataset inference loop on one device.

Port of ``r3det_tpu/utils/eval_loop.py::evaluate_dataset`` for one card:
each batch's samples are read and decoded on the host, their uint8 images
copied to the model's device, transformed there (``RResize``,
``Normalize``, ``Pad``: bit-equal to the CPU) and stacked; the port's
predict step runs on the batch (the tail batch padded by repeating its
last image); the padded detections come back to the host, where
``scale_factor`` is undone on ``[:4]`` (not the angle) and
``rbbox2result`` splits them by class.

Gathering results across processes comes with data parallelism (ROADMAP
Queue 1 item 4): under an initialized process group of more than one rank
it raises.
"""
import time

import numpy as np
import torch

from ..core.rtransforms_np import rbbox2result
from ..datasets.transforms import Normalize, Pad, RResize
from ..parallel.predict import make_predict_step


def _world_size():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def test_pipeline(hw):
    """The test pipeline for an (h, w) image size: ``RResize`` to it,
    ``Normalize``, ``Pad`` to the fixed canvas (``hw`` rounded up to a
    multiple of 32); returns (stages, canvas)."""
    canvas = tuple(-(-d // 32) * 32 for d in hw)
    return [RResize((hw[1], hw[0])), Normalize(),
            Pad(32, fixed_size=canvas)], canvas


def transform_batch(samples, pipeline, device):
    """Decoded samples (``get_sample`` dicts, uint8 ``img`` on the host)
    -> (B, H, W, 3) f32 on ``device``: each image copied there and taken
    through ``pipeline``, which updates its sample in place (``img``,
    ``img_shape``, ``scale_factor``)."""
    for s in samples:
        s['img'] = torch.from_numpy(s['img']).to(device)
        for stage in pipeline:
            stage(s)
    return torch.stack([s['img'] for s in samples])


def evaluate_dataset(model, det_cfg, ds, img_size=1024, batch_size=4,
                     progress=None, times=None):
    """Run inference over every image of ``ds`` on the model's device.

    Returns a list (len(ds)) of per-class numpy det lists (the
    rbbox2result format the DOTA evaluator and submission writer eat).

    img_size: int (square) or (h, w); the anchor grid and the fixed pad
    canvas derive from its divisor-rounded form. ``times``, a dict, gets
    seconds added under ``decode`` (reading and decoding), ``transforms``
    (the copy to the device and the transforms) and ``predict`` (the
    predict step and its results back on the host), with the device
    synchronized at each phase's edges (leave it None when not timing).
    """
    if _world_size() > 1:
        raise NotImplementedError(
            'evaluate_dataset runs on one device; gathering results across '
            'processes is not ported yet (ROADMAP.md, Queue 1 item 4)')
    hw = (img_size, img_size) if isinstance(img_size, int) \
        else tuple(img_size)
    pipeline, canvas = test_pipeline(hw)
    featmap_sizes = tuple((canvas[0] // s, canvas[1] // s)
                          for s in det_cfg.strides)
    predict = make_predict_step(model, det_cfg, featmap_sizes,
                                img_shape=canvas)
    device = next(model.parameters()).device
    sync = torch.cuda.synchronize if device.type == 'cuda' else (
        lambda: None)
    clock = [time.perf_counter()]

    def lap(phase):
        if times is not None:
            sync()
            now = time.perf_counter()
            times[phase] = times.get(phase, 0.0) + now - clock[0]
            clock[0] = now

    results = [None] * len(ds)
    for start in range(0, len(ds), batch_size):
        idxs = list(range(start, min(start + batch_size, len(ds))))
        samples = [ds.get_sample(i) for i in idxs]
        lap('decode')
        imgs = transform_batch(samples, pipeline, device)
        if len(imgs) < batch_size:           # pad the tail batch
            imgs = torch.cat([imgs, imgs[-1:].expand(
                batch_size - len(imgs), -1, -1, -1)])
        lap('transforms')
        dets, labels, num = (t.cpu().numpy() for t in predict(imgs))
        for bi, (i, s) in enumerate(zip(idxs, samples)):
            n = int(num[bi])
            d = dets[bi, :n].astype(np.float32)
            d[:, :4] /= s['scale_factor']     # angle not rescaled
            results[i] = rbbox2result(d, labels[bi, :n],
                                      det_cfg.num_classes)
        lap('predict')
        if progress is not None:
            progress(idxs[-1] + 1, len(ds))
    return results
