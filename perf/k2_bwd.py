#!/usr/bin/env python3
"""Where the time of K2's backward goes, on one CUDA card.

    python3 perf/k2_bwd.py [--old OLD_FRM_SAMPLE_CU]

Times K2's backward (``r3det_frm_sample_bwd`` in
``r3det_tpu_torch/csrc/frm_sample.cu``) at the training shapes of
``chip_smoke.py`` (the five levels of a 1024^2 image, batch 2, 256
channels), points 1 and 5, beside debug copies of the same source with
the tail of its phases cut off or one step cut out (``CUTS``, the
source's ``kStopAfter``, ``kCutSort``, ``kCutGather``): ``stop0`` the
launch alone, ``stop1`` the setup, ``stop2`` and ``stop3`` the block sums
and the scan after it, ``stop4`` the fill after them, ``no_sort`` every
phase with the ids walked unsorted, ``no_gather`` every phase with the
sort but not the gather. A copy with ``kPhaseClock`` stamps the end of
each phase (block 0, ``%globaltimer``, after the grid barrier) in one
launch, which gives ``phase_us``. ``torch_add`` (``torch.add(g, 1)`` into
dfeat a level: g read once, dfeat written once) is the floor of the
function's own bytes. ``--old`` also builds and times an earlier version
of the source with the atomic entry point (an f32 buffer zeroed each
call, float atomics, a grid barrier), in the same call. The main-path and
collide rois come from ``chip_smoke.py``. Each variant runs twice, in
turns; CUDA events over 20 calls after warm-up, each call with its
workspace zero fill. ``*_peak_mb``: the device memory one call
allocates, its outputs included, through the wrapper and the old entry
point. Checks the full kernel bit for bit against
``frm_sample_levels_bwd_ordered`` on CPU copies. Prints one JSON object
and which phase takes the most time.
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
from chip_smoke import (SEED, TRAIN_BATCH, frm_collide_rois,  # noqa: E402
                        frm_inputs)
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import frm_sample as K2  # noqa: E402
from perf.k3_stem import build, cuda_ms  # noqa: E402

PHASES = ('setup', 'sums', 'scan', 'fill', 'sort_gather')
STOP = 'constexpr int kStopAfter = 5;'
CUTS = {f'stop{k}': [(STOP, STOP.replace('5', str(k)))] for k in range(5)}
CUTS['no_sort'] = [('constexpr bool kCutSort = false;',
                    'constexpr bool kCutSort = true;')]
CUTS['no_gather'] = [('constexpr bool kCutGather = false;',
                      'constexpr bool kCutGather = true;')]
CUTS['clock'] = [('constexpr bool kPhaseClock = false;',
                  'constexpr bool kPhaseClock = true;')]


def old_call(lib, grads, rois, scales, trig, points, dfeats):
    """A call of the atomic entry point: its zeroed f32 sums and barrier,
    allocated and zeroed as its wrapper did, then the launch."""
    n = len(grads)
    sizes = [g.numel() for g in grads]
    buf = torch.zeros(sum(sizes) + 4, dtype=torch.float32,
                      device=grads[0].device)
    accs = list(torch.split(buf[:-4], sizes))

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    err = lib.r3det_frm_sample_bwd(
        n, ptrs(grads), ptrs(rois), ptrs(accs), ptrs(dfeats),
        (ctypes.c_int * n)(*(g.shape[1] for g in grads)),
        (ctypes.c_int * n)(*(g.shape[2] for g in grads)),
        (ctypes.c_float * n)(*map(float, scales)),
        None if trig is None else trig.data_ptr(), buf[-4:].data_ptr(),
        grads[0].shape[0], grads[0].shape[-1], points, 1,
        _ext.current_stream(grads[0].device))
    if err:
        raise RuntimeError(f'old launch error {err}')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', help='an earlier frm_sample.cu (the atomic '
                    'entry point) to time beside')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k2_bwd: no CUDA device', file=sys.stderr)
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
    if args.old:
        sources['old'] = open(args.old).read()

    rng = np.random.RandomState(SEED)
    _, feats, rois, scales = frm_inputs(rng, dev, TRAIN_BATCH)
    grads = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32)).to(
        dev, torch.bfloat16) for f in feats]
    del feats
    collide = [torch.from_numpy(r).to(dev) for r in frm_collide_rois(
        rng, TRAIN_BATCH)]
    dfeats = [torch.empty_like(g) for g in grads]
    cells = sum(g.shape[0] * g.shape[1] * g.shape[2] for g in grads)
    res = {'card': card, 'levels': [list(g.shape) for g in grads]}
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, lib in libs.items():
            lib.r3det_frm_sample_bwd.restype = ctypes.c_int
            if name == 'old':
                lib.r3det_frm_sample_bwd.argtypes = [
                    ctypes.c_int] + [ctypes.c_void_p] * 9 + [
                    ctypes.c_int] * 4 + [ctypes.c_void_p]
            else:
                lib.r3det_frm_sample_bwd.argtypes = list(
                    _ext._SIGNATURES['frm_sample_bwd'])
        for points in (1, 5):
            for tag, rr in (('', rois), ('collide_', collide)):
                trig = K2.angle_trig(rr) if points == 5 else None
                zeroed, ws = K2.bwd_workspace(cells, points, dev)
                for name, lib in libs.items():
                    if tag and name not in ('full', 'old'):
                        continue
                    if name == 'old':
                        def call(lib=lib, rr=rr, trig=trig, points=points):
                            old_call(lib, grads, rr, scales, trig, points,
                                     dfeats)
                    else:
                        cargs = K2.bwd_args(grads, rr, dfeats, scales, trig,
                                            zeroed, ws, points, True)

                        def call(lib=lib, cargs=cargs, zeroed=zeroed,
                                 name=name):
                            zeroed.zero_()
                            err = lib.r3det_frm_sample_bwd(*cargs)
                            if err:
                                raise RuntimeError(
                                    f'{name} launch error {err}')
                    fns[f'{tag}{name}_points{points}'] = call
                if tag:
                    continue
                # the phase clock: one launch, its stamps
                fns[f'clock_points{points}']()
                torch.cuda.synchronize()
                r4 = (cells + 3) // 4 * 4
                st = zeroed[r4 + 4:r4 + 16].view(torch.int64).cpu().tolist()
                res[f'phase_us_points{points}'] = {
                    ph: (st[i + 1] - st[i]) / 1e3
                    for i, ph in enumerate(PHASES)}
                del fns[f'clock_points{points}']
                # the wrapper as the train step calls it
                fns[f'wrapper_points{points}'] = (
                    lambda rr=rr, trig=trig, points=points:
                    K2.frm_sample_levels_bwd_cuda(grads, rr, scales, points,
                                                  trig=trig))
                # the full kernel against its ordered plain form
                fns[f'full_points{points}']()
                torch.cuda.synchronize()
                want = K2.frm_sample_levels_bwd_ordered(
                    [g.cpu() for g in grads], [r.cpu() for r in rois],
                    scales, points, True,
                    None if trig is None else trig.cpu())
                res[f'full_points{points}_bit_equal'] = all(
                    torch.equal(d.cpu().view(torch.int16),
                                w.view(torch.int16))
                    for d, w in zip(dfeats, want))
                del want

        def stream_add():
            for g, d in zip(grads, dfeats):
                torch.add(g, 1, out=d)
        fns['torch_add'] = stream_add
        for rep in range(2):
            order = list(fns) if rep == 0 else list(reversed(list(fns)))
            for tag in order:
                res.setdefault(tag, []).append(cuda_ms(fns[tag], iters=20))
        # device memory a call allocates, outputs included, as the train
        # step calls it
        for points in (1, 5):
            trig = K2.angle_trig(rois) if points == 5 else None
            calls = {'wrapper': lambda: K2.frm_sample_levels_bwd_cuda(
                grads, rois, scales, points, trig=trig)}
            if 'old' in libs:
                calls['old'] = lambda: old_call(
                    libs['old'], grads, rois, scales, trig, points,
                    [torch.empty_like(g) for g in grads])
            for name, fn in calls.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                fn()
                torch.cuda.synchronize()
                res[f'{name}_points{points}_peak_mb'] = (
                    torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    for points in (1, 5):
        us = res[f'phase_us_points{points}']
        res[f'slowest_phase_points{points}'] = max(us, key=us.get)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
