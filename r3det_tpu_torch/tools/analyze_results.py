"""Render the best and worst predictions by per-image mAP.

    python -m r3det_tpu_torch.tools.analyze_results CONFIG RESULTS.pkl
        [--show-dir analyze_out] [--topk 10]

Port of ``tools/analysis_tools/analyze_results.py``, with its arguments:
score each image of the config's ``data.val`` split by the mAP of its
detections in ``RESULTS.pkl`` (``tools/test.py --out``) against its own
annotations (``datasets/dota.py::eval_rbbox_map``), sort by (mAP, index),
and draw the ``--topk`` worst into ``bad/`` and the best into ``good/``,
each as ``f"{mAP:.3f}_{id}.png"`` (``core/visualization.py``). It runs on
the host only.

One difference from the JAX tool: the dataset takes the split's
``classes`` when the config gives them (as both test CLIs do), where the
JAX tool always takes DOTA-v1.0's 15, so that a 3-class model's results
score against its own classes; on a config without ``classes`` the two
tools agree.
"""
import argparse
import os
import os.path as osp
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Analyze prediction quality')
    p.add_argument('config')
    p.add_argument('results', help='pickle from tools/test.py --out')
    p.add_argument('--show-dir', default='analyze_out')
    p.add_argument('--topk', type=int, default=10)
    return p.parse_args(argv)


def image_dets(result):
    """One image's per-class (n, 6) detections -> (n, 7) rows with the
    class id last."""
    return np.concatenate([
        np.concatenate([d, np.full((len(d), 1), c, np.float32)], -1)
        for c, d in enumerate(result) if len(d)] or
        [np.zeros((0, 7), np.float32)])


def main(argv=None):
    args = parse_args(argv)

    from ..core.visualization import imshow_det_rbboxes
    from ..datasets.dota import DOTADataset, eval_rbbox_map
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    version = cfg.model.bbox_head.bbox_coder.get('angle_range', 'v1')
    val_d = cfg.data.val
    ds = DOTADataset(val_d.ann_file, val_d.get('img_prefix'),
                     version=version, filter_empty=False,
                     classes=val_d.get('classes'))
    # the pickle is this program's own output (tools/test.py --out)
    with open(args.results, 'rb') as f:
        results = pickle.load(f)
    if len(results) != len(ds):
        raise ValueError(f'{len(results)} results for {len(ds)} images')

    scores = []
    for i, (res, info) in enumerate(zip(results, ds.data_infos)):
        m, _ = eval_rbbox_map([res], [info['ann']], version=version,
                              class_names=ds.CLASSES, logger=None, nproc=1)
        scores.append((m, i))
    scores.sort()

    os.makedirs(osp.join(args.show_dir, 'good'), exist_ok=True)
    os.makedirs(osp.join(args.show_dir, 'bad'), exist_ok=True)
    for tag, chunk in (('bad', scores[:args.topk]),
                       ('good', scores[-args.topk:])):
        for m, i in chunk:
            info = ds.data_infos[i]
            dets = image_dets(results[i])
            out = osp.join(args.show_dir, tag, f"{m:.3f}_{info['id']}.png")
            imshow_det_rbboxes(osp.join(ds.img_folder, info['filename']),
                               dets[:, :6], dets[:, 6].astype(int),
                               class_names=ds.CLASSES, out_file=out)
    print(f'wrote top/bottom-{args.topk} visualizations to {args.show_dir}')


if __name__ == '__main__':
    main()
