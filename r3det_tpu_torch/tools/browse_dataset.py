"""Render the train pipeline's output for dataset inspection.

    python -m r3det_tpu_torch.tools.browse_dataset CONFIG
        [--output-dir browse_out] [--limit 20] [--device cuda]

Port of ``tools/misc/browse_dataset.py``, with its arguments plus
``--device``: run the config's own train pipeline
(``TrainPipeline.from_config`` on ``data.train.pipeline``, without its
``Normalize`` and ``Pad``, so the images stay in pixels) over the first
``--limit`` samples of ``data.train``, and draw each augmented image with
its ground-truth boxes (``score_thr=0``) into ``f"{img_id}.png"``. The
transforms run on the card unless given ``--device cpu``; the random
stages draw from an unseeded generator, as the JAX tool's do. As
``analyze_results``, the dataset takes the config's ``classes`` where it
gives them.
"""
import argparse
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Browse dataset pipeline output')
    p.add_argument('config')
    p.add_argument('--output-dir', default='browse_out')
    p.add_argument('--limit', type=int, default=20)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..core.visualization import imshow_det_rbboxes
    from ..datasets.dota import DOTADataset
    from ..datasets.transforms import Normalize, Pad, TrainPipeline
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    version = cfg.model.bbox_head.bbox_coder.get('angle_range', 'v1')
    train_d = cfg.data.train
    ds = DOTADataset(train_d.ann_file, train_d.get('img_prefix'),
                     version=version, classes=train_d.get('classes'))
    # the config's own pipeline (flip ratios, scales and rotations take
    # effect); only Normalize and Pad are dropped
    pipeline = TrainPipeline.from_config(
        train_d.get('pipeline', []), version=version, device=args.device)
    stages = [s for s in pipeline.stages
              if not isinstance(s, (Normalize, Pad))]

    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(min(args.limit, len(ds))):
        r = ds.get_sample(i)
        r['img'] = torch.from_numpy(r['img']).to(pipeline.device)
        for s in stages:
            r = s(r)
            if r is None:
                break
        if r is None:
            continue
        out = osp.join(args.output_dir, f"{r['img_id']}.png")
        imshow_det_rbboxes(r['img'].cpu().numpy(), r['gt_bboxes'],
                           r['gt_labels'], class_names=ds.CLASSES,
                           score_thr=0, out_file=out)
    print(f'wrote visualizations to {args.output_dir}')


if __name__ == '__main__':
    main()
