#!/usr/bin/env python3
"""Where the rotated-IoU kernel's time goes, on one CUDA card.

    python3 perf/k1_iou.py [--old OLD_ROTATED_IOU_CU]

Times K1 (``r3det_tpu_torch/csrc/rotated_iou.cu``) at the main path's
shape, (8, 4000, 4000), on ``chip_smoke.py``'s synthetic scene with NMS's
zero-fill rules (``upper_only``, the same valid counts), beside debug
copies of the same source with one phase cut out each (the near pairs'
integral, the far pairs' zero stores, the whole cull pass, the per-box
cos/sin), the kernel with every tile zero-filled (valid count 0: the
output write alone) and ``out.zero_()`` (PyTorch's fill of the same
output). ``--old`` also builds and times an
earlier version of the source (same C entry point). Each variant runs
twice, in turns; CUDA events over 20 launches after warm-up. Prints one
JSON object. Debug builds go to a temporary directory.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import BATCH, IOU_BUDGETS, SEED, iou_boxes  # noqa: E402
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import rotated_iou as K1  # noqa: E402
from perf.k3_stem import build, cuda_ms  # noqa: E402

# each cut replaces a loop bound or a guard of the source, so that the
# phase does no work
CUTS = {
    'no_integral': ('e < n_near; e += kThreads', 'e < 0; e += kThreads'),
    'no_far_stores': ('if (col_ok && far) o[', 'if (false) o['),
    # no cull test either: a computed tile stages its boxes and stores
    # nothing
    'no_cull_pass': ('r < rows; r += kThreads / kTileC',
                     'r < 0; r += kThreads / kTileC'),
    'no_trig': ('= cosf(t);\n  planes[kSin * stride + k] = sinf(t);',
                '= t;\n  planes[kSin * stride + k] = t;'),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', help='an earlier rotated_iou.cu to time beside')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k1_iou: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = open(os.path.join(_ext.CSRC, 'rotated_iou.cu')).read()
    sources = {'full': src}
    for name, (a, b) in CUTS.items():
        if a not in src:
            raise RuntimeError(f'cut {name}: {a!r} not in the source')
        sources[name] = src.replace(a, b)
    if args.old:
        sources['old'] = open(args.old).read()

    # chip_smoke.py's first K1 scene: the same seed and draws
    k = IOU_BUDGETS[0]
    rng = np.random.RandomState(SEED)
    boxes = torch.from_numpy(iou_boxes(rng, BATCH, k)).to(dev)
    vc = torch.from_numpy(rng.randint(k // 4, k + 1, BATCH)
                          .astype(np.int32)).to(dev)
    vc[0] = k
    zeros = torch.zeros_like(vc)
    out = torch.empty((BATCH, k, k), dtype=torch.float32, device=dev)
    stream = _ext.current_stream(dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, lib in libs.items():
            lib.r3det_rotated_iou.argtypes = [P] * 4 + [I] * 7 + [P]

            def call(lib=lib, name=name, v=vc):
                err = lib.r3det_rotated_iou(
                    boxes.data_ptr(), boxes.data_ptr(), v.data_ptr(),
                    out.data_ptr(), BATCH, k, k, 0, 1, K1.tile_rows(k),
                    K1.TILE_C, stream)
                if err:
                    raise RuntimeError(f'{name} launch error {err}')
            fns[name] = call
        fns['write_only'] = lambda: fns['full'](v=zeros)
        fns['torch_zero_'] = out.zero_
        want = K1.rotated_iou_reference(boxes, boxes, upper_only=True,
                                        valid_count=vc)
        res = {'card': card, 'shape': [BATCH, k, k]}
        for name in ('full', 'old') if args.old else ('full',):
            fns[name]()
            torch.cuda.synchronize()
            res[f'{name}_max_abs_err'] = float((out - want).abs().max())
        del want
        for rep in range(2):
            order = list(fns) if rep == 0 else list(reversed(list(fns)))
            for tag in order:
                res.setdefault(tag, []).append(cuda_ms(fns[tag], iters=20))
    print(json.dumps(res, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
