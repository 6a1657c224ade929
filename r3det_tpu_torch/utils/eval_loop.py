"""Dataset inference loop, on one card or strided over the ranks of a
process group.

Port of ``r3det_tpu/utils/eval_loop.py::evaluate_dataset``: each batch's
samples are read and decoded on the host, their uint8 images
copied to the model's device, transformed there (``RResize``,
``Normalize``, ``Pad``: bit-equal to the CPU) and stacked; the port's
predict step runs on the batch (the tail batch padded by repeating its
last image); the padded detections come back to the host, where
``scale_factor`` is undone on ``[:4]`` (not the angle) and
``rbbox2result`` splits them by class.

With a process group of R ranks, rank r runs images ``r::R`` (the JAX
loop's process stride) in batches of its own, and the results are
gathered so that every rank returns the full list (the JAX loop's
``_allgather_results``), each image exactly once.
"""
import time

import numpy as np
import torch

from ..core.rtransforms_np import rbbox2result
from ..datasets.transforms import Normalize, Pad, RResize
from ..parallel import dist
from ..parallel.predict import make_predict_step


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
                     progress=None, times=None, process_group=None):
    """Run inference over every image of ``ds`` on the model's device.

    Returns a list (len(ds)) of per-class numpy det lists (the
    rbbox2result format the DOTA evaluator and submission writer eat).
    With ``process_group`` this rank runs its stride of the images
    (``batch_size`` a rank) and every rank returns the full list;
    ``progress`` then counts this rank's images.

    img_size: int (square) or (h, w); the anchor grid and the fixed pad
    canvas derive from its divisor-rounded form. ``times``, a dict, gets
    seconds added under ``decode`` (reading and decoding), ``transforms``
    (the copy to the device and the transforms) and ``predict`` (the
    predict step and its results back on the host), with the device
    synchronized at each phase's edges (leave it None when not timing).
    """
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

    rank, ranks = (0, 1) if process_group is None else (
        dist.rank(process_group), dist.world_size(process_group))
    mine = list(range(rank, len(ds), ranks))
    results = {}
    for start in range(0, len(mine), batch_size):
        idxs = mine[start:start + batch_size]
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
            progress(start + len(idxs), len(mine))
    if ranks > 1:
        gathered = {}
        for part in dist.gather_objects(results, process_group):
            if gathered.keys() & part.keys():
                raise RuntimeError('an image was run on two ranks')
            gathered.update(part)
        results = gathered
    if sorted(results) != list(range(len(ds))):
        raise RuntimeError(f'{len(results)} results for {len(ds)} images')
    return [results[i] for i in range(len(ds))]
