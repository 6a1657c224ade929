#!/usr/bin/env python3
"""Where the fused bottleneck kernel's time goes, on one CUDA card.

    python3 perf/k5_bottleneck.py [--old OLD_BOTTLENECK_CU]

Times K5 (``r3det_tpu_torch/csrc/bottleneck.cu``, bf16 and int8) at R50's
identity blocks at batch 8 and 1024^2 (C2 (8, 256, 256, 256) F=64, C3 (8,
128, 128, 512) F=128, C4 (8, 64, 64, 1024) F=256), on weights packed once
(``pack_bottleneck``, its time on its own line), beside copies of the same
source with one phase cut out each (the source's ``kCut*`` / ``kSyncCopies``
flags set): no MMA, no weight stream, no conv1 recompute (conv1 on the 128
output pixels, not the 180 of the halo), synchronous copies (rings one
stage deep; q8 still stages x two chunks ahead). The cut copies compute
wrong results; only their times count. ``--old`` also builds and times an earlier version
of the source with its own C entry points (``r3det_bottleneck(x, w1, b1,
w2, b2, w3, b3, out, B, H, W, F, stream)``, weights ``[n][k]``), on
weights transposed and quantized once, so the old kernel is timed without
its wrapper's per-call repack. Each variant runs twice, in turns; CUDA
events over 20 launches after warm-up. Prints one JSON object. Debug
builds go to a temporary directory.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import bottleneck_fuse as K5  # noqa: E402

# each cut: the source flag set to true in its copy
CUTS = {
    'no_mma': 'kCutMma',
    'no_weights': 'kCutWeights',
    'no_recompute': 'kCutRecompute',
    'sync_copies': 'kSyncCopies',
}
STAGES = (('C2', (8, 256, 256), 64), ('C3', (8, 128, 128), 128),
          ('C4', (8, 64, 64), 256))


def build(sources, tmp):
    """nvcc each ``{name: source text}`` into its own library, in parallel;
    returns {name: ctypes library}."""
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(tmp, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_ext.find_nvcc(), *_ext.NVCC_FLAGS, '-shared', '-o',
             os.path.join(tmp, f'lib{name}.so'), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(os.path.join(tmp, f'lib{name}.so'))
    return libs


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_inputs(rng, shape, f, dev):
    c4 = 4 * f
    x = torch.from_numpy(rng.normal(0, 1, shape + (c4,)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ws = [torch.from_numpy(rng.normal(0, std, s).astype(np.float32)).to(dev)
          for s, std in (((1, 1, c4, f), c4 ** -0.5), ((f,), 0.1),
                         ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 0.1),
                         ((1, 1, f, c4), f ** -0.5), ((c4,), 0.1))]
    amax = [x.float().abs().amax(), torch.tensor(4.0, device=dev),
            torch.tensor(3.0, device=dev)]
    return x, ws, amax


def old_operands(ws, amax, f, q8):
    """The PR-start kernel's operands: [n][k] weights (bf16 or int8 codes),
    f32 biases and (int8) inv and the dequant factors."""
    c4 = 4 * f
    w1, b1, w2, b2, w3, b3 = ws
    if not q8:
        bf = torch.bfloat16
        return dict(w=(w1.reshape(c4, f).t().to(bf).contiguous(),
                       w2.reshape(9, f, f).transpose(1, 2).to(bf).contiguous(),
                       w3.reshape(f, c4).t().to(bf).contiguous()),
                    b=(b1, b2, b3))
    (w1i, ks1), (w2i, ks2), (w3i, ks3) = (
        K5._wq(w1.reshape(c4, f)), K5._wq(w2.reshape(9, f, f)),
        K5._wq(w3.reshape(f, c4)))
    a1, a2, a3 = K5._act_scales(*amax)
    return dict(w=(w1i.t().contiguous(), w2i.transpose(1, 2).contiguous(),
                   w3i.t().contiguous()),
                b=(b1, b2, b3),
                s=[t.contiguous() for t in (a1 * ks1, a2 * ks2, a3 * ks3)],
                inv=torch.stack([1.0 / a1, 1.0 / a2, 1.0 / a3]).contiguous())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', help='an earlier bottleneck.cu to time beside')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k5_bottleneck: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = open(os.path.join(_ext.CSRC, 'bottleneck.cu')).read()
    sources = {'full': src}
    for name, flag in CUTS.items():
        line = f'constexpr bool {flag} = false;'
        if line not in src:
            raise RuntimeError(f'cut {name}: {line!r} not in the source')
        sources[name] = src.replace(line, f'constexpr bool {flag} = true;')
    if args.old:
        sources['old'] = open(args.old).read()
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = _ext.current_stream(dev)
    sms = _ext.sm_count(dev)
    res = {'card': card}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build(sources, tmp)
        res['build_s'] = round(time.perf_counter() - t0, 1)
        for name, lib in libs.items():
            if name == 'old':
                lib.r3det_bottleneck.argtypes = [P] * 8 + [I] * 4 + [P]
                lib.r3det_bottleneck_q8.argtypes = [P] * 12 + [I] * 4 + [P]
            else:
                lib.r3det_bottleneck.argtypes = [P] * 6 + [I] * 5 + [P]
                lib.r3det_bottleneck_q8.argtypes = [P] * 10 + [I] * 5 + [P]
        rng = np.random.RandomState(0)
        for stage, shape, f in STAGES:
            x, ws, amax = stage_inputs(rng, shape, f, dev)
            out = torch.empty_like(x)
            dims = (*shape, f)
            for q8 in (False, True):
                tag = f'{stage}_{"q8" if q8 else "bf16"}'
                extra = amax if q8 else []
                pack = K5.pack_bottleneck(*ws, *extra)
                res[f'{tag}_pack_ms'] = cuda_ms(
                    lambda: K5.pack_bottleneck(*ws, *extra), iters=5)
                old = old_operands(ws, amax, f, q8) if args.old else None
                fns = {}
                for name, lib in libs.items():
                    def call(lib=lib, name=name):
                        if name == 'old':
                            (w1, w2, w3), (b1, b2, b3) = old['w'], old['b']
                            if q8:
                                s1, s2, s3 = old['s']
                                err = lib.r3det_bottleneck_q8(
                                    x.data_ptr(), old['inv'].data_ptr(),
                                    w1.data_ptr(), s1.data_ptr(),
                                    b1.data_ptr(), w2.data_ptr(),
                                    s2.data_ptr(), b2.data_ptr(),
                                    w3.data_ptr(), s3.data_ptr(),
                                    b3.data_ptr(), out.data_ptr(), *dims,
                                    stream)
                            else:
                                err = lib.r3det_bottleneck(
                                    x.data_ptr(), w1.data_ptr(),
                                    b1.data_ptr(), w2.data_ptr(),
                                    b2.data_ptr(), w3.data_ptr(),
                                    b3.data_ptr(), out.data_ptr(), *dims,
                                    stream)
                        elif q8:
                            err = lib.r3det_bottleneck_q8(
                                x.data_ptr(), pack.inv.data_ptr(),
                                pack.weights.data_ptr(), pack.s1.data_ptr(),
                                pack.b1.data_ptr(), pack.s2.data_ptr(),
                                pack.b2.data_ptr(), pack.s3.data_ptr(),
                                pack.b3.data_ptr(), out.data_ptr(), *dims,
                                sms, stream)
                        else:
                            err = lib.r3det_bottleneck(
                                x.data_ptr(), pack.weights.data_ptr(),
                                pack.b1.data_ptr(), pack.b2.data_ptr(),
                                pack.b3.data_ptr(), out.data_ptr(), *dims,
                                sms, stream)
                        if err:
                            raise RuntimeError(f'{name} launch error {err}')
                    fns[name] = call
                plain = (K5.fused_bottleneck_q8_reference if q8 else
                         K5.fused_bottleneck_reference)(x, *ws, *extra)
                for name in ('full', 'old') if args.old else ('full',):
                    fns[name]()
                    torch.cuda.synchronize()
                    diff = (out.float() - plain.float()).abs()
                    res[f'{tag}_{name}_max_abs_err'] = float(diff.max())
                    res[f'{tag}_{name}_exact_frac'] = float(
                        (diff == 0).float().mean())
                del plain, diff
                for rep in range(2):
                    order = list(fns)[::1 if rep == 0 else -1]
                    for name in order:
                        res.setdefault(f'{tag}_{name}', []).append(
                            cuda_ms(fns[name]))
            del x, out, ws
            torch.cuda.empty_cache()
    for q in ('bf16', 'q8'):
        for name in sources:
            res[f'sum_{q}_{name}'] = [
                sum(res[f'{st}_{q}_{name}'][i] for st, _, _ in STAGES)
                for i in range(2)]
    print(json.dumps(res, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
