#!/usr/bin/env python3
"""Where the fused stem kernel's time goes, on one CUDA card.

    python3 perf/k3_stem.py [--old OLD_STEM_POOL_CU]

Times K3 (``r3det_tpu_torch/csrc/stem_pool.cu``, bf16 and int8) at the
main path's shape, (8, 512, 512, 12) -> (8, 256, 256, 64), on weights
packed once (``pack_stem``) and with max|x| taken once, beside debug copies
of the same source with one phase cut out each: the pool, the MMAs, the
epilogue's stores, the halo copy, the int8 quantize. ``--old`` also builds
and times an earlier version of the source (its ``r3det_stem_conv_pool``
entry points without the SM count, weights in that version's layout:
``[tap][co][16 channels]`` bf16, ``[ky][kx pair][co][32]`` int8) and its
per-call wrapper cost (weight packing and ``abs().amax()`` in the call).
Each variant runs twice, in turns; CUDA events over 50 launches after
warm-up. Prints one JSON object. Debug builds go to a temporary
directory.
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
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from r3det_tpu_torch import _ext  # noqa: E402
from r3det_tpu_torch.ops import stem_pool as K3  # noqa: E402
from r3det_tpu_torch.ops.int8_conv import quantize_weights  # noqa: E402

# each cut replaces a loop bound or a guard of the source, so that the
# phase does no work (the cut int8 halo leaves stale input: the quantize
# then runs on whatever the buffer holds)
CUTS = {
    'no_pool': ('item < kTP * kTQ * (kCout / 8); item += kThreads',
                'item < 0; item += kThreads'),
    'no_mma': ('for (int ky = 0; ky < kK; ++ky) {',
               'for (int ky = 0; ky < 0; ++ky) {'),
    'no_epilogue': ('if (p >= kPix) continue;', 'if (p >= 0) continue;'),
    'no_halo': ('i < kIR * kChunks; i += kThreads', 'i < 0; i += kThreads'),
    'no_quant': ('p < kIR * kIC; p += kThreads', 'p < 0; p += kThreads'),
}
B, H, W = 8, 512, 512


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


def cuda_ms(fn, iters=50, warmup=3):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--old', help='an earlier stem_pool.cu to time beside')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k3_stem: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = open(os.path.join(_ext.CSRC, 'stem_pool.cu')).read()
    sources = {'full': src}
    for name, (a, b) in CUTS.items():
        if a not in src:
            raise RuntimeError(f'cut {name}: {a!r} not in the source')
        sources[name] = src.replace(a, b)
    if args.old:
        sources['old'] = open(args.old).read()

    rng = np.random.RandomState(0)
    x12 = torch.from_numpy(rng.uniform(-2, 2, (B, H, W, 12)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kern = torch.from_numpy(rng.normal(0, 0.1, (4, 4, 12, 64)).astype(
        np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 2, 64).astype(np.float32)).to(
        dev)
    bias = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).to(dev)
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.bfloat16,
                      device=dev)
    amax = K3.abs_max(x12)
    sms = _ext.sm_count(dev)
    stream = _ext.current_stream(dev)
    packs = {False: K3.pack_stem(kern, scale, bias),
             True: K3.pack_stem(kern, scale, bias, quantize=True)}

    def old_pack(q8):
        if q8:
            ki, ks = quantize_weights(kern, axes=(0, 1, 2))
            w = F.pad(ki, (0, 0, 0, 4)).reshape(4, 2, 2, 16, 64)
            return (w.permute(0, 1, 4, 2, 3).contiguous(),
                    ks.reshape(-1).contiguous())
        w = F.pad(kern.reshape(16, 12, 64), (0, 0, 0, 4))
        return w.permute(0, 2, 1).to(torch.bfloat16).contiguous(), None

    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, lib in libs.items():
            old = name == 'old'
            tail = [I] * (3 if old else 4) + [P]
            lib.r3det_stem_conv_pool.argtypes = [P] * 5 + tail
            lib.r3det_stem_conv_pool_q8.argtypes = [P] * 7 + tail
            for q8 in (False, True):
                def call(lib=lib, q8=q8, old=old, name=name,
                         per_call=False):
                    if old:
                        w, ks = old_pack(q8) if per_call else \
                            old_packed[q8]
                        a = x12.abs().amax().float().reshape(1) \
                            if per_call else amax
                        dims = (B, H, W)
                    else:
                        p = packs[q8]
                        w, ks, a, dims = p.weights, p.kscale, amax, \
                            (B, H, W, sms)
                    if q8:
                        err = lib.r3det_stem_conv_pool_q8(
                            x12.data_ptr(), w.data_ptr(), a.data_ptr(),
                            ks.data_ptr(), scale.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), *dims, stream)
                    else:
                        err = lib.r3det_stem_conv_pool(
                            x12.data_ptr(), w.data_ptr(), scale.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), *dims, stream)
                    if err:
                        raise RuntimeError(f'{name} launch error {err}')
                tag = f'{name}_{"q8" if q8 else "bf16"}'
                fns[tag] = call
                if old:
                    fns[f'old_wrapper_{"q8" if q8 else "bf16"}'] = \
                        lambda call=call: call(per_call=True)
        old_packed = {q8: old_pack(q8) for q8 in (False, True)}
        res = {'card': card}
        # the full and the old kernels against their plain versions
        for q8 in (False, True):
            plain = (K3.stem_conv_pool_q8_reference if q8
                     else K3.stem_conv_pool_reference)(x12, kern, scale, bias)
            for name in ('full', 'old') if args.old else ('full',):
                fns[f'{name}_{"q8" if q8 else "bf16"}']()
                torch.cuda.synchronize()
                res[f'{name}_{"q8" if q8 else "bf16"}_max_abs_err'] = float(
                    (out.float() - plain.float()).abs().max())
            del plain
        for rep in range(2):
            order = list(fns) if rep == 0 else list(reversed(list(fns)))
            for tag in order:
                res.setdefault(tag, []).append(cuda_ms(fns[tag]))
    print(json.dumps(res, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
