#!/usr/bin/env python3
"""Where the FRM sample kernel's time goes, on one CUDA card.

    python3 perf/k2_frm.py [--old OLD_FRM_SAMPLE_CU ...]

Times K2 (``r3det_tpu_torch/csrc/frm_sample.cu``) on ``chip_smoke.py``'s
main-path inputs, the five levels of batch 8 at 1024^2 (P3..P7, 256
channels) in one ``r3det_frm_sample_levels`` launch, with points=1 and
points=5, beside debug copies of the same source with one thing cut or
changed each (``CUTS``): no corner loads (the x, feat and out streams
with the roi staging alone), the corner points moved onto the centre (the
same loads and arithmetic from rows already in L1), two cells in flight
a warp, points=5 with its corner loads one point ahead of the sums and
at 3 blocks an SM, a contiguous run of tiles a block, plain loads and
stores instead of the evict-first ones. ``torch.add(x, feat, out=out)``
over the five levels is the plain stream of the same bytes (two reads and
a write). ``--old`` (repeatable) also builds and times earlier versions of
the source: through ``r3det_frm_sample_levels`` where the version has it
(points 1 and 5), else through its one-level ``r3det_frm_sample`` entry,
five launches (points=1). Each variant runs twice, in turns; CUDA events
over 20 launches after warm-up. Prints one JSON object. Debug builds go
to a temporary directory.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import SEED, frm_inputs  # noqa: E402
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import frm_sample as K2  # noqa: E402
from perf.k3_stem import build, cuda_ms  # noqa: E402

# each cut replaces pieces of the source (the outputs of a cut are wrong)
BLOCKS = '__launch_bounds__(kThreads, P == 1 ? 4 : 2)'
CUTS = {
    # every point outside the map: no corner loads
    'no_corners': [('const bool inside = row > -1.0f',
                    'const bool inside = false && row > -1.0f')],
    # the four corner points sample the centre: the same loads and
    # arithmetic, all from the centre's rows (L1)
    'near_corners': [('return k > 0 ? corner_setup(r0 + dy, c0 + dx, H, W)',
                      'return k > 0 ? corner_setup(r0, c0, H, W)')],
    'two_cells_in_flight': [('launch<1, 1>(p, s)', 'launch<1, 2>(p, s)')],
    # points=5: corner loads one point ahead of the sums, not all first
    'p5_ahead1': [('constexpr int kAhead = P - 1;',
                   'constexpr int kAhead = P > 1 ? 1 : 0;')],
    # points=5 at 3 blocks an SM (85 registers)
    'p5_3blocks': [(BLOCKS, BLOCKS.replace(': 2)', ': 3)'))],
    # a contiguous run of tiles a block, not every grid-th tile
    'chunked': [('const int first = blockIdx.x, step = gridDim.x, last = '
                 'p.tiles;',
                 'const int per = (p.tiles + gridDim.x - 1) / gridDim.x, '
                 'first = blockIdx.x * per, step = 1, '
                 'last = min(first + per, p.tiles);')],
    # plain loads of x and stores of out instead of evict-first ones
    'no_cache_hints': [
        ('__stcs(reinterpret_cast<uint4*>(v.out + row[k] + c), pack(o));',
         '*reinterpret_cast<uint4*>(v.out + row[k] + c) = pack(o);'),
        ('__ldcs(', '__ldg(')],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', action='append', default=[],
                    help='an earlier frm_sample.cu to time beside')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k2_frm: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = open(os.path.join(_ext.CSRC, 'frm_sample.cu')).read()
    sources = {'full': src}
    for name, pieces in CUTS.items():
        sources[name] = src
        for a, b in pieces:
            if a not in src:
                raise RuntimeError(f'cut {name}: {a!r} not in the source')
            sources[name] = sources[name].replace(a, b)
    for k, path in enumerate(args.old):
        sources[f'old{k}'] = open(path).read()

    xs, feats, rois, scales = frm_inputs(np.random.RandomState(SEED), dev)
    outs = [torch.empty_like(f) for f in feats]
    trig = K2.angle_trig(rois)
    stream = _ext.current_stream(dev)
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, lib in libs.items():
            lib.r3det_frm_sample.argtypes = list(
                _ext._SIGNATURES['frm_sample'])
            if not hasattr(lib, 'r3det_frm_sample_levels'):
                def call(lib=lib, name=name):
                    for x, f, r, o, s in zip(xs, feats, rois, outs, scales):
                        b, h, w, c = f.shape
                        err = lib.r3det_frm_sample(
                            x.data_ptr(), f.data_ptr(), r.data_ptr(),
                            o.data_ptr(), b, h, w, c, s, 1, stream)
                        if err:
                            raise RuntimeError(f'{name} launch error {err}')
                fns[f'{name}_points1'] = call
                continue
            lib.r3det_frm_sample_levels.argtypes = list(
                _ext._SIGNATURES['frm_sample_levels'])
            for points in (1, 5):
                largs = K2.levels_args(xs, feats, rois, outs, scales,
                                       trig if points == 5 else None, points,
                                       True)

                def call(lib=lib, largs=largs, name=name):
                    err = lib.r3det_frm_sample_levels(*largs)
                    if err:
                        raise RuntimeError(f'{name} launch error {err}')
                fns[f'{name}_points{points}'] = call

        def stream_add():
            for x, f, o in zip(xs, feats, outs):
                torch.add(x, f, out=o)
        fns['torch_add'] = stream_add
        res = {'card': card, 'levels': [list(f.shape) for f in feats]}
        for name in [n for n in fns if n.startswith(('full', 'old'))]:
            points = int(name[-1])
            fns[name]()
            torch.cuda.synchronize()
            want = K2.frm_sample_levels_reference(xs, feats, rois, scales,
                                                  points)
            res[f'{name}_bit_equal'] = all(
                torch.equal(o, w) for o, w in zip(outs, want))
            del want
        for rep in range(2):
            order = list(fns) if rep == 0 else list(reversed(list(fns)))
            for tag in order:
                res.setdefault(tag, []).append(cuda_ms(fns[tag], iters=20))
    print(json.dumps(res, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
