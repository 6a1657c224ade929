#!/usr/bin/env python3
"""The controls of a serving cell's limits one precision below, on the
card, at the cell's own sizes, many seeds in one process:

    python3 portbench/fp8_control.py --workload CELL --seeds 1,2,... \
        [--out FILE]

For each seed it reads the numbers of the sound program on the window
steps drawn from the seed (``readings.serve_samples``; kind
``program``), then the same numbers with the reference one precision
below in the program's place at every stage the check judges (kind
``control_fp8``): ``err.fpn`` from the reference's backbone in fp8 (e4m3:
every linear's and conv's input, output and weight rounded,
``check.quantized``) and its FPN in float32 on the same images;
``err.tower.s0.*`` from the reference's towers in fp8 on the program's
FPN; ``err.final.*`` and ``det_mismatch`` as ``check.serve_numbers``'
``control`` gives them (the final convs in fp8, decode and NMS in
bfloat16). One JSON line a reading goes to standard output and to
``--out``, with ``correct`` as the cell's limits judge its numbers
(``cli.evaluate``): a limit between the two kinds reads the first true
and the second false.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(HERE)] + [
    p for p in sys.path if os.path.abspath(p or '.') != HERE]

import torch  # noqa: E402

from portbench.bench import check, common, serve  # noqa: E402
from portbench.bench.cli import evaluate  # noqa: E402
from portbench.bench.manifest import Manifest  # noqa: E402
from portbench.readings import serve_samples  # noqa: E402


def fp8_towers(head, x):
    """The reference head's towers on ``x`` with every conv in fp8."""
    mods = list(head.modules())
    for m in mods:
        m.quant = 'fp8'
    try:
        return head.towers(x)
    finally:
        for m in mods:
            m.quant = None


def readings(cfg, traffic, seed, device):
    b = serve.build(cfg, traffic, seed, device)
    samples = serve_samples(b, seed)
    ref, rcfg, sizes = b['ref'], b['rcfg'], b['sizes']
    del b
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    nums, live = check.serve_numbers(samples, ref, rcfg, sizes,
                                     (traffic['size'],) * 2)
    extra = {'live_mean': sum(live) / len(live)}
    yield 'program', nums, extra
    low, _ = check.serve_numbers(samples, ref, rcfg, sizes,
                                 (traffic['size'],) * 2, control=True)
    low = dict(low)
    head = ref.bbox_head
    with check.no_tf32(), torch.no_grad():
        for images, cap, _ in samples:
            want = ref.neck(ref.backbone(images))
            got = ref.neck(check.quantized(ref.backbone, 'fp8', images))
            low['err.fpn'] = max(low.get('err.fpn', 0.0),
                                 check.rel_err(got, want))
            del want, got
            fpn = [t.float() for t in cap['fpn']]
            want = list(zip(*[head.towers(x) for x in fpn]))
            got = list(zip(*[fp8_towers(head, x) for x in fpn]))
            for i, branch in enumerate(('cls', 'reg')):
                key = f'err.tower.s0.{branch}'
                low[key] = max(low.get(key, 0.0),
                               check.rel_err(got[i], want[i]))
    yield 'control_fp8', low, extra


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('fp8_control: no CUDA card', file=sys.stderr)
        return 2
    man = Manifest()
    cell = man.cell(args.workload)
    cfg = man.config(cell['config'])
    traffic = man.traffic(cell['traffic'])
    limits = man.limits(args.workload).get('numbers', {})
    device = torch.device('cuda', 0)
    card = common.card_info(device)
    out = open(args.out, 'a') if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(',') if s):
            t = time.perf_counter()
            for kind, nums, extra in readings(cfg, traffic, seed, device):
                judged = evaluate(nums, limits)
                line = json.dumps(dict(
                    workload=args.workload, seed=seed, kind=kind,
                    numbers=nums, card=card,
                    correct=all(ok for *_, ok in judged),
                    seconds=time.perf_counter() - t, **extra))
                print(line, flush=True)
                if out:
                    out.write(line + '\n')
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
