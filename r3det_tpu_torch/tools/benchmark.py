"""Inference or train-step throughput of a config's detector.

    python -m r3det_tpu_torch.tools.benchmark CONFIG [--img-size 1024]
        [--batch-size 1] [--max-iter 200] [--warmup 5] [--forward-only]
        [--mode infer|train] [--device cuda] [--cfg-options k=v ...]
    torchrun --nproc_per_node N -m r3det_tpu_torch.tools.benchmark CONFIG \
        --mode train --launcher pytorch [--dist-backend nccl|gloo] ...

Port of ``tools/analysis_tools/benchmark.py``, with its output line. The
weights come from ``--seed`` (``seeded_state_dict``); the model computes
in bf16 on the card and in f32 on the CPU. ``infer`` times the predict
step (decode and NMS included) or, with ``--forward-only``, the network
alone, on four seeded image batches in turn, reading one number back to
the host every iteration as the JAX tool does. ``--mode train`` times the
train step (forward, losses, backward, the SGD update) on
``SyntheticDetData``; under a process group (``--launcher pytorch``, or
``--dist-url``) it is the data-parallel step, ``--batch-size`` the global
batch split over the ranks, and rank 0 prints. On a card the first line
names it and its power limit (``nvidia-smi``), since the times depend on
both.
"""
import argparse
import subprocess
import time

import numpy as np

from ..parallel import dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Benchmark inference FPS')
    p.add_argument('config')
    p.add_argument('--img-size', type=int, default=1024)
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--max-iter', type=int, default=200)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--forward-only', action='store_true',
                   help='skip decode+NMS (pure network fwd)')
    p.add_argument('--mode', choices=['infer', 'train'], default='infer')
    p.add_argument('--seed', type=int, default=0,
                   help='numpy seed of the weights and the data')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; cuda:LOCAL_RANK under a group), "
                        "'cuda:N' or 'cpu'")
    dist.add_launcher_args(p)
    return p.parse_args(argv)


def card_line(device):
    """nvidia-smi's name and power limit of ``device``, or 'cpu'."""
    import torch
    if device.type != 'cuda':
        return 'cpu'
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', str(index)], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()


def main(argv=None):
    """Run the benchmark; returns images/s (rank 0's under a group)."""
    args = parse_args(argv)
    with dist.launched(args, 'benchmark') as (group, device):
        return _bench(args, device, group)


def _bench(args, device, group):
    import torch

    from ..models.detectors import detector_predict
    from ..utils.builder import build_from_config
    from ..utils.config import Config
    from ..utils.convert import seeded_state_dict

    lead = dist.rank(group) == 0
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model, det_cfg = build_from_config(cfg, dtype=dtype, device=device)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    if lead:
        print(card_line(device), flush=True)
    size, bs = args.img_size, args.batch_size
    featmap_sizes = tuple((size // s, size // s) for s in det_cfg.strides)
    if args.mode == 'train':
        return bench_train(args, model, det_cfg, featmap_sizes, device,
                           group)

    imgs = [torch.from_numpy(np.random.RandomState(i).uniform(
        -2, 2, (bs, size, size, 3)).astype(np.float32)).to(device)
        for i in range(4)]

    @torch.no_grad()
    def run(x):
        out = model(x)
        if args.forward_only:
            leaves = [t for lvl in out['s0'] for t in lvl] + [
                t for stage in out.get('sr', []) for lvl in stage
                for t in lvl]
            return float(sum(t.float().sum() for t in leaves))
        dets, _, _ = detector_predict(out, det_cfg, featmap_sizes,
                                      img_shape=(size, size),
                                      kernels=model.kernels)
        return float(dets.sum())

    run(imgs[0])                                   # first call: warm-up
    for i in range(args.warmup):
        run(imgs[i % 4])
    t0 = time.perf_counter()
    for i in range(args.max_iter):
        run(imgs[i % 4])                           # host read: a sync
    dt = time.perf_counter() - t0
    fps = args.max_iter * bs / dt
    print(f'{fps:.2f} img/s ({dt / args.max_iter * 1e3:.1f} ms/iter, '
          f'batch {bs}, {size}x{size})')
    return fps


def bench_train(args, model, det_cfg, featmap_sizes, device, group):
    """Train-step throughput (forward, losses, backward, update) on
    synthetic data; under a group the data-parallel step on the global
    batch ``--batch-size``, each rank its rows."""
    import torch

    from ..datasets.synthetic import SyntheticDetData
    from ..parallel.train import make_train_step

    size, bs = args.img_size, args.batch_size
    rank, ranks = dist.rank(group), dist.world_size(group)
    if bs % ranks:
        raise ValueError(f'--batch-size {bs} does not split over {ranks} '
                         'ranks')
    local = bs // ranks
    data = SyntheticDetData(batch_size=bs, size=size,
                            num_classes=det_cfg.num_classes,
                            version=det_cfg.angle_version, seed=args.seed)
    rows = slice(rank * local, (rank + 1) * local)
    batches = [{k: torch.from_numpy(v[rows]).to(device)
                for k, v in data.batch().items()} for _ in range(4)]
    if group is not None:
        dist.broadcast_state(model, None, group)
    step = make_train_step(model, det_cfg, featmap_sizes, device=device,
                           process_group=group)
    losses = step(batches[0])                      # first call: warm-up
    if rank == 0:
        print('loss after the first step:', float(losses['total']))
    for i in range(args.warmup):
        float(step(batches[i % 4])['total'])
    t0 = time.perf_counter()
    for i in range(args.max_iter):
        float(step(batches[i % 4])['total'])       # host read: a sync
    dt = time.perf_counter() - t0
    fps = args.max_iter * bs / dt
    if rank == 0:
        print(f'train: {fps:.2f} img/s ({dt / args.max_iter * 1e3:.1f} '
              f'ms/step, batch {bs}, {size}x{size}'
              + (f', {ranks} ranks over {args.dist_backend})'
                 if group is not None else ')'))
    return fps


if __name__ == '__main__':
    main()
