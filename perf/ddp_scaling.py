#!/usr/bin/env python3
"""Data-parallel training across the cards of one machine.

    python3 perf/ddp_scaling.py

On every card the machine shows (one rank a card over NCCL), as
``chip_smoke.py``'s ``[ddp_nccl]``: R3Det R50 as shipped, bf16 on f32
parameters, seeded weights, a global ``SyntheticDetData`` batch of 4 at
1024^2 split over the ranks, two steps of the data-parallel
``make_train_step`` held to one process on the whole batch (losses within
2%, parameters within 5% of the update, ranks bit-identical). Then the
train step's images/s from ``r3det_tpu_torch.tools.benchmark --mode
train`` at 2 images a card: on all cards under torchrun, on one card
without a group, and on all cards again, in turns. Prints the card's
name and power limit first.
"""
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BENCH = ['-m', 'r3det_tpu_torch.tools.benchmark',
         'configs/r3det/r3det_r50_fpn_1x_dota_v1.py', '--mode', 'train',
         '--max-iter', '20', '--warmup', '3']


def main():
    import torch

    import chip_smoke
    from r3det_tpu_torch import _ext

    if not torch.cuda.is_available():
        print('ddp_scaling: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _ext.build()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as work:
        ref = chip_smoke.ddp_reference(dev)
        rec = chip_smoke.ddp_step(n, 'nccl', list(range(n)), ref, work)
    print(f'[ddp_nccl] world_size={n} loss_rel_err={rec["loss_err"]:.6f} '
          f'param_rel_l2_of_update={rec["param_err"]:.6f} '
          f'ranks_bit_identical={rec["same"]} ms_per_step={rec["ms"]} '
          f'allreduce_ms={rec["allreduce_ms"]:.3f} '
          f'peak_gb_per_rank={[round(p / 2 ** 30, 3) for p in rec["peaks"]]}',
          flush=True)
    torchrun = [sys.executable, '-m', 'torch.distributed.run',
                '--standalone', '--nproc_per_node', str(n)]
    every = torchrun + BENCH + ['--batch-size', str(2 * n), '--launcher',
                                'pytorch']
    one = [sys.executable] + BENCH + ['--batch-size', '2']
    for cmd in (every, one, every):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            return out.returncode
        print(f'[ddp_bench] cards={n if cmd is every else 1} '
              f'seconds={time.perf_counter() - t0:.1f} '
              f'{out.stdout.strip().splitlines()[-1]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
