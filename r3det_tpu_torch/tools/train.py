"""Train a rotated detector from a config file through the port.

    python -m r3det_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--max-steps N] [--synthetic] [--device cuda]

Port of ``tools/train.py`` on one card (data parallelism is not ported
yet: ROADMAP.md, Queue 1 item 4). The arguments are the JAX CLI's, plus
``--device`` (the card by default; without one it raises unless given
``--device cpu``). The model computes in bf16 on f32 parameters on the
card and in f32 on the CPU; its weights come from ``--seed``
(``seeded_state_dict``), as the JAX CLI's from ``model.init``, and
``--pretrained-backbone`` overwrites the backbone with a torchvision
ResNet state dict (``.pth`` or ``.npz``).

The chain is the JAX CLI's: config -> builder -> ``DOTADataset`` ->
``TrainPipeline`` (from the config's train pipeline, its Pad pinned to
the canvas: the RResize scale rounded up to 32) -> ``DetLoader`` -> the
SGD train step (``optimizer``, ``lr_config``, ``optimizer_config``) ->
``train_log.jsonl`` (``step``, ``imgs_per_sec``, ``lr`` and the losses
every ``--log-interval`` steps), checkpoints every
``checkpoint_config.interval`` epochs and at the end, and the eval hook
(``evaluation.interval`` epochs: ``evaluate_dataset`` over
``data.val`` and its mAP). A resumed run restores the parameters, the
momentum and the update count, so the LR schedule and the sampler's
generator go on from the saved step; its loader starts a new epoch, as
the JAX CLI's does.
"""
import argparse
import json
import os
import os.path as osp
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a rotated detector')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-steps', type=int, default=None,
                   help='override total steps (default: epochs * len(loader))')
    p.add_argument('--synthetic', action='store_true',
                   help='train on synthetic data (no dataset needed)')
    p.add_argument('--img-size', type=int, default=None,
                   help='override the pipeline RResize scale (default: '
                        'the config pipeline\'s img_scale, else 1024)')
    p.add_argument('--log-interval', type=int, default=50)
    p.add_argument('--pretrained-backbone', default=None,
                   help='path to a torchvision resnet .pth/.npz state dict')
    p.add_argument('--profile', default=None, metavar='DIR',
                   help='capture a torch.profiler trace of steps 10-15 '
                        'into DIR')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='key=value dotted-path config overrides')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def train_pipeline_cfg(cfg, img_size=None):
    """The config's train pipeline (a default one where it has none) and
    its (h, w) canvas: ``img_size`` squared, else the pipeline's RResize
    ``img_scale`` ((w, h), mmcv's order), else 1024, rounded up to 32.
    ``img_size`` also rewrites the RResize scale."""
    train_d = cfg.get('data', {}).get('train', {})
    cfg_scale = None                          # (w, h)
    for s in train_d.get('pipeline') or []:
        if s.get('type') == 'RResize' and s.get('img_scale'):
            sc = s['img_scale']
            cfg_scale = (sc, sc) if isinstance(sc, int) else tuple(sc)
    if img_size:
        size_hw = (img_size, img_size)
    elif cfg_scale:
        size_hw = (cfg_scale[1], cfg_scale[0])
    else:
        size_hw = (1024, 1024)
    pipeline = [dict(s) for s in train_d.get('pipeline') or [
        dict(type='RResize', img_scale=(size_hw[1], size_hw[0])),
        dict(type='RRandomFlip', flip_ratio=0.5),
        dict(type='Normalize'), dict(type='Pad', size_divisor=32)]]
    if img_size:
        for s in pipeline:
            if s.get('type') == 'RResize':
                s['img_scale'] = (img_size, img_size)
    return pipeline, tuple(-(-d // 32) * 32 for d in size_hw)


def build_train_loader(cfg, det_cfg, batch_size, seed, device,
                       img_size=None, synthetic=False):
    """The CLI's data: (iterable of batches on ``device``, iterations an
    epoch, (h, w) canvas). ``synthetic`` gives ``SyntheticDetData`` on a
    square canvas, 100 iterations an epoch."""
    import torch
    pipeline_cfg, canvas = train_pipeline_cfg(cfg, img_size)
    if synthetic:
        from ..datasets.synthetic import SyntheticDetData
        data = SyntheticDetData(batch_size=batch_size, size=max(canvas),
                                num_classes=det_cfg.num_classes,
                                version=det_cfg.angle_version, seed=seed)
        loader = ({k: torch.from_numpy(v).to(device) for k, v in b.items()}
                  for b in data)
        return loader, 100, (max(canvas), max(canvas))
    from ..datasets.dota import DOTADataset
    from ..datasets.loader import DetLoader
    from ..datasets.transforms import TrainPipeline
    train_d = cfg.data.train
    ds = DOTADataset(train_d.ann_file, train_d.get('img_prefix'),
                     version=det_cfg.angle_version,
                     classes=train_d.get('classes'))
    pipeline = TrainPipeline.from_config(
        pipeline_cfg, version=det_cfg.angle_version, seed=seed,
        device=device)
    pipeline.pad_to(*canvas)                 # one shape for every sample
    loader = DetLoader(ds, pipeline, batch_size=batch_size, seed=seed,
                       device=device)
    return loader, len(loader), canvas


def main(argv=None):
    """Run the CLI; returns a dict: ``model``, ``optimizer``, ``step``,
    ``history`` (the train log's records), ``metrics`` (the last eval's,
    or None), ``canvas``, and per step the seconds the loop waited for
    its batch (``wait_s``) and the seconds from that wait to the end of
    the step's log (``iter_s``: the wait, the step and, on a log step,
    the sync that reads its losses; checkpoints and evals left out)."""
    args = parse_args(argv)
    import torch

    from ..parallel.train import (make_lr_schedule, make_optimizer,
                                  make_train_step)
    from ..utils.builder import build_from_config
    from ..utils.checkpoint import (load_pretrained_backbone,
                                    load_state_dict_file, restore_checkpoint,
                                    save_checkpoint)
    from ..utils.config import Config
    from ..utils.convert import seeded_state_dict

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('train: no CUDA card; pass --device cpu to '
                           'train on the CPU')
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model, det_cfg = build_from_config(cfg, dtype=dtype, device=device)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    print(f'model: {type(model).__name__}  angle={det_cfg.angle_version}  '
          f'refine_stages={det_cfg.num_refine_stages}')
    print('device:', torch.cuda.get_device_name(device)
          if device.type == 'cuda' else 'cpu')

    # ---- data -------------------------------------------------------
    batch_size = cfg.get('data', Config({})).get('samples_per_gpu', 2)
    loader, iters_per_epoch, canvas = build_train_loader(
        cfg, det_cfg, batch_size, args.seed, device, args.img_size,
        args.synthetic)

    max_epochs = cfg.get('runner', Config({})).get('max_epochs', 12)
    total_steps = args.max_steps or max_epochs * iters_per_epoch
    opt_cfg = cfg.get('optimizer', Config({}))
    lr_cfg = cfg.get('lr_config', Config({}))
    lr_schedule = make_lr_schedule(
        base_lr=opt_cfg.get('lr', 2.5e-3),
        warmup_iters=lr_cfg.get('warmup_iters', 500),
        warmup_ratio=lr_cfg.get('warmup_ratio', 1.0 / 3),
        step_epochs=lr_cfg.get('step', [8, 11]),
        iters_per_epoch=iters_per_epoch)
    opt = make_optimizer(
        model.parameters(), lr_schedule,
        momentum=opt_cfg.get('momentum', 0.9),
        weight_decay=opt_cfg.get('weight_decay', 1e-4),
        clip_norm=cfg.get('optimizer_config', Config({})).get(
            'grad_clip', Config({})).get('max_norm', 35.0))

    # ---- state ------------------------------------------------------
    if args.pretrained_backbone:
        load_pretrained_backbone(
            model, load_state_dict_file(args.pretrained_backbone),
            det_cfg.backbone_depth)
        print(f'loaded pretrained backbone from {args.pretrained_backbone}')
    step_i = 0
    if args.resume_from:
        step_i = restore_checkpoint(args.resume_from, model, opt)
        print(f'resumed from {args.resume_from} @ step {step_i}')
    featmap_sizes = tuple((canvas[0] // s, canvas[1] // s)
                          for s in det_cfg.strides)
    step_fn = make_train_step(model, det_cfg, featmap_sizes, optimizer=opt,
                              device=device)

    # ---- eval hook (the reference's EvalHook: evaluation.interval) ---
    eval_cfg = cfg.get('evaluation', Config({}))
    eval_interval = eval_cfg.get('interval', 0) * iters_per_epoch \
        if not args.synthetic and cfg.get('data') and \
        cfg.data.get('val') else 0
    val_ds = None

    def run_eval():
        nonlocal val_ds
        from ..datasets.dota import DOTADataset
        from ..utils.eval_loop import evaluate_dataset
        if val_ds is None:
            val_d = cfg.data.val
            val_ds = DOTADataset(val_d.ann_file, val_d.get('img_prefix'),
                                 version=det_cfg.angle_version,
                                 filter_empty=False,
                                 classes=val_d.get('classes'))
        results = evaluate_dataset(model, det_cfg, val_ds, img_size=canvas,
                                   batch_size=batch_size)
        return val_ds.evaluate(results)

    # ---- loop -------------------------------------------------------
    log_path = osp.join(work_dir, 'train_log.jsonl')
    ckpt_interval = cfg.get('checkpoint_config', Config({})).get(
        'interval', 12) * iters_per_epoch
    history, wait_s, iter_s, metrics = [], [], [], None
    prof = None
    t0 = time.perf_counter()
    data_iter = iter(loader)
    logf = open(log_path, 'a')
    try:
        while step_i < total_steps:
            t_wait = time.perf_counter()
            try:
                batch = next(data_iter)
            except StopIteration:
                data_iter = iter(loader)
                batch = next(data_iter)
            wait_s.append(time.perf_counter() - t_wait)
            if args.profile and step_i == 10:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == 'cuda'
                    else []))
                prof.start()
            losses = step_fn(batch)
            step_i += 1
            if prof is not None and step_i == 15:
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
                prof.stop()
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(osp.join(args.profile,
                                                  'trace.json'))
                print(f'profiler trace -> {args.profile}')
                prof = None
            if step_i % args.log_interval == 0 or step_i == total_steps:
                losses = {k: float(v) for k, v in losses.items()}
                dt = time.perf_counter() - t0
                ips = args.log_interval * batch['image'].shape[0] / dt
                rec = dict(step=step_i, imgs_per_sec=round(ips, 2),
                           lr=float(lr_schedule(step_i)), **losses)
                print('  '.join(f'{k}={v:.4f}' if isinstance(v, float)
                                else f'{k}={v}' for k, v in rec.items()))
                logf.write(json.dumps(rec) + '\n')
                logf.flush()
                history.append(rec)
                t0 = time.perf_counter()
            iter_s.append(time.perf_counter() - t_wait)
            if step_i % max(ckpt_interval, 1) == 0 or step_i == total_steps:
                path = save_checkpoint(osp.join(work_dir, 'ckpt'), step_i,
                                       model, opt)
                print(f'checkpoint -> {path}')
            if eval_interval and (step_i % eval_interval == 0 or
                                  step_i == total_steps):
                metrics = run_eval()
                rec = dict(step=step_i, mode='val',
                           **{k: float(v) for k, v in metrics.items()})
                print(f'val mAP @ step {step_i}: '
                      f'{metrics.get("mAP", float("nan")):.4f}')
                logf.write(json.dumps(rec) + '\n')
                logf.flush()
    finally:
        if prof is not None:                 # the run ended before step 15
            prof.stop()
        logf.close()
        data_iter.close()                    # stops the loader's threads
    return dict(model=model, optimizer=opt, step=step_i, history=history,
                metrics=metrics, canvas=canvas, wait_s=wait_s, iter_s=iter_s)


if __name__ == '__main__':
    main()
