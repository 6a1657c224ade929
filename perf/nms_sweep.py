#!/usr/bin/env python3
"""Where the NMS sweep kernel's time goes, on one CUDA card.

    python3 perf/nms_sweep.py

On ``chip_smoke.py``'s sweep scenes (K1's IoU of 8 x 4000 candidates with
~3000 live and of 8 x 2000 with ~300; 15 labels, v3 holes), times the
whole op (``ops/nms.py::greedy_keep_gated_cuda``: the scratch allocation
and one launch of ``csrc/nms_sweep.cu``'s entry) with CUDA events over 50
calls, each of its two kernels by ``torch.profiler``'s device time, and
the plain route (the gate and the blocked fixpoint, host syncs included).
Prints one JSON object.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import BATCH, SEED, SWEEP_SCENES, sweep_scene  # noqa: E402
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import nms  # noqa: E402
from r3det_tpu_torch.utils.kernel_timing import cuda_ms  # noqa: E402

CALLS = 50


def kernel_us(args):
    """Mean device microseconds a call of each kernel, by name."""
    nms.greedy_keep_gated_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            nms.greedy_keep_gated_cuda(*args)
        torch.cuda.synchronize()
    names = ((re.search(r'nms_\w+_kernel', e.key), e)
             for e in prof.key_averages())
    return {m.group(0): e.device_time_total / e.count for m, e in names if m}


def main():
    if not torch.cuda.is_available():
        print('nms_sweep: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    _ext.build()
    rng = np.random.RandomState(SEED)
    out = dict(card=card)
    for k, live in SWEEP_SCENES:
        args = sweep_scene(rng, dev, k, live)
        keep = nms.greedy_keep_gated_cuda(*args)
        out[f'({BATCH},{k})'] = dict(
            live=args[1].sum(1).tolist(), kept=keep.sum(1).tolist(),
            equal=torch.equal(keep, nms.greedy_keep_gated_reference(*args)),
            ms=cuda_ms(lambda: nms.greedy_keep_gated_cuda(*args), CALLS),
            kernel_us=kernel_us(args),
            plain_ms=cuda_ms(lambda: nms.greedy_keep_gated_reference(*args),
                             5))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
