"""Evaluate or format results of a rotated detector through the port.

    python -m r3det_tpu_torch.tools.test CONFIG [CHECKPOINT]
        [--eval mAP | --format-only]
    torchrun --nproc_per_node N -m r3det_tpu_torch.tools.test CONFIG \
        [CHECKPOINT] --launcher pytorch [--dist-backend nccl|gloo] ...

Port of ``tools/test.py``: build the detector from a config, run it over
the config's ``data.test`` split, then ``--eval mAP`` (DOTA polygon mAP)
or ``--format-only`` (merge patches, write the Task1 submission and its
zip). The arguments are the JAX CLI's, plus ``--device`` (the card by
default; without one it raises unless given ``--device cpu``), ``--seed``,
the numpy seed of the weights (``seeded_state_dict``) used where no
checkpoint is given, as the JAX CLI's ``model.init`` weights are, and the
process group's (``dist.add_launcher_args``, as the train CLI's). The
checkpoint is ``tools.train``'s (``save_checkpoint``) or a published one
(``publish_checkpoint``); an int8 model keeps its own activation ranges
where the checkpoint has none (``load_weights``), and ``--calibrate-int8``
sets them. The model computes in bf16 on the card and in f32 on the CPU.

Under a group of R ranks (the JAX CLI's mesh eval), every rank takes rank
0's weights, calibrates on the same first batches (checked equal across
ranks), runs its stride of the images and holds the gathered results;
rank 0 alone writes ``--out``, the submission and the metrics.

One difference from the JAX CLI: the stem is fused (K3) by default, so
``--fused-kernels`` keeps it so.
"""
import argparse
import pickle
import time

from ..parallel import dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a rotated detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help="a checkpoint of tools.train or publish_model "
                        "(default: weights from --seed)")
    p.add_argument('--out', default=None, help='dump raw results pickle')
    p.add_argument('--eval', default=None, choices=[None, 'mAP'])
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--format-dir', default='submission')
    p.add_argument('--img-size', type=int, default=None,
                   help='override the test pipeline img_scale (default: '
                        'the config test pipeline\'s scale, else 1024)')
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--calibrate-int8', type=int, default=0, metavar='N',
                   help='with quantize_int8 models: freeze per-conv '
                        'activation scales from N dataset batches before '
                        'inference (default: dynamic scales)')
    p.add_argument('--fused-kernels', action='store_true',
                   help='the fused stem kernel (K3); the port fuses the '
                        'stem by default, so this keeps the default')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--seed', type=int, default=0,
                   help='numpy seed of the weights')
    dist.add_launcher_args(p)
    return p.parse_args(argv)


def pipeline_image_size(test_d, img_size=None):
    """(h, w) of the test pipeline: ``img_size`` squared, else the config
    test pipeline's RResize / MultiScaleFlipAug scale, else 1024."""
    cfg_scale = None                          # (w, h)
    for s in (test_d.get('pipeline') or []):
        if s.get('type') in ('RResize', 'MultiScaleFlipAug') and \
                s.get('img_scale'):
            sc = s['img_scale']
            sc = sc[0] if isinstance(sc, (list, tuple)) and \
                isinstance(sc[0], (list, tuple)) else sc
            cfg_scale = (sc, sc) if isinstance(sc, int) else tuple(sc)
    if img_size:
        return (img_size, img_size)
    if cfg_scale:
        return (cfg_scale[1], cfg_scale[0])
    return (1024, 1024)


def calibration_batches(ds, n_batches, batch_size, hw, device):
    """The first ``n_batches`` batches of ``ds`` through the test
    pipeline, as (B, H, W, 3) f32 tensors on ``device``."""
    from ..utils.eval_loop import test_pipeline, transform_batch
    pipeline, _ = test_pipeline(hw)
    return [transform_batch([ds.get_sample(i) for i in range(
                start, min(start + batch_size, len(ds)))], pipeline, device)
            for start in range(0, min(n_batches * batch_size, len(ds)),
                               batch_size)]


def main(argv=None):
    """Run the CLI; returns the metrics of ``--eval mAP`` (rank 0's under
    a group), else None."""
    args = parse_args(argv)
    with dist.launched(args, 'test') as (group, device):
        return _test(args, device, group)


def _test(args, device, group):
    import torch

    from ..datasets.dota import DOTADataset
    from ..models.quant import calibrate
    from ..utils.builder import build_from_config
    from ..utils.checkpoint import load_weights
    from ..utils.config import Config
    from ..utils.convert import seeded_state_dict
    from ..utils.eval_loop import evaluate_dataset

    lead = dist.rank(group) == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model, det_cfg = build_from_config(cfg, dtype=dtype, device=device)
    if args.checkpoint:
        load_weights(args.checkpoint, model)
        say(f'loaded {args.checkpoint}')
    else:
        model.load_state_dict(seeded_state_dict(model, args.seed))
    dist.broadcast_state(model, None, group)

    # evaluate whatever split the config's test dict points at, like the
    # reference; point data.test at an annotated split to --eval it
    test_d = cfg.data.test
    ds = DOTADataset(test_d.ann_file, test_d.get('img_prefix'),
                     version=det_cfg.angle_version, filter_empty=False,
                     test_mode=not args.eval,
                     classes=test_d.get('classes'))
    say(f'{len(ds)} images')
    hw = pipeline_image_size(test_d, args.img_size)
    bs = max(args.batch_size, 1)

    if det_cfg.quantize and args.calibrate_int8:
        # freeze per-conv activation scales from real data so serving
        # skips the dynamic max|x| pass (models/quant.py); every rank
        # calibrates on the same first batches, so the ranges agree
        batches = calibration_batches(ds, args.calibrate_int8, bs, hw,
                                      device)
        with torch.no_grad():
            calibrate(model, batches)
        dist.check_replicas(model, None, group)
        say(f'int8 activation scales calibrated over '
            f'{len(batches)} batches')

    t0 = time.time()

    def progress(done, total):
        if done % (20 * bs) < bs or done == total:
            say(f'{done}/{total}  '
                f'({done / (time.time() - t0):.1f} img/s)')

    results = evaluate_dataset(model, det_cfg, ds, img_size=hw,
                               batch_size=bs, progress=progress,
                               process_group=group)
    if not lead:
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
        print(f'raw results -> {args.out}')
    if args.format_only:
        zip_path = ds.format_results(results, args.format_dir)
        print(f'submission -> {zip_path}')
    if args.eval == 'mAP':
        metrics = ds.evaluate(results)
        print({k: round(v, 4) for k, v in metrics.items()})
        return metrics
    return None


if __name__ == '__main__':
    main()
