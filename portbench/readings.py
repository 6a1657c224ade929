#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own sizes, many seeds in one process:

    python3 portbench/readings.py --workload CELL --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out FILE]

For each of ``--seeds`` it reads the numbers of sound runs of the program
(the lower readings). For each of ``--control-seeds`` it reads:

- serving: the program's own int8 path switched on (``quantize`` and
  ``quantize_head`` 'static', ``int8_act``, calibrated on the first pool
  batch): the control of the backbone, FPN, FRM and towers, one precision
  below bf16; and, on the sound program's samples, the reference one
  precision below in the program's place where that path leaves the
  program in bf16 or float32 (``check.serve_numbers``' ``control``): each
  head's final convs in fp8 and decode and NMS in bfloat16;
- training: the reference in the program's place with every conv's
  input, output (per tensor) and weight (per output channel) rounded to
  int8, and again to fp8 (e4m3): the controls; and the fault "half of the
  batch left out, the mean taken over the rest", planted in the reference
  (the loss over the batch's first half). The float32 reference each is
  compared with follows its rois.

A step that returns its state unchanged reads 1 on ``change_gap`` by its
definition and needs no run. One JSON line a reading goes to standard
output and to ``--out``, with ``correct`` as the cell's limits judge its
numbers (``cli.evaluate``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ['TRITON_CACHE_DIR'] = os.path.join(HERE, '.cache', 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(HERE, '.cache',
                                                  'torch_extensions')
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or '.') != HERE]

import torch  # noqa: E402

from portbench.bench import check, common, serve, train  # noqa: E402
from portbench.bench.cli import evaluate  # noqa: E402
from portbench.bench.manifest import Manifest  # noqa: E402

INT8 = {'quantize': 'static', 'quantize_head': 'static', 'int8_act': True}


def serve_samples(b, seed):
    """Run each pool batch through the program's step and keep the outputs
    of ``serve.SAMPLES`` of them, drawn from the seed."""
    last = {}
    hooks = serve.capture(b['model'], last)
    pool = b['pool']
    keep = random.Random(common.derive_seed(seed, 3)).sample(
        range(len(pool)), min(serve.SAMPLES, len(pool)))
    out = []
    for i in range(len(pool)):
        dets, labels, num = b['step'](pool[i])
        got = (dets.cpu(), labels.cpu(), num.cpu())
        if i in keep:
            out.append((pool[i], dict(last), got))
    for h in hooks:
        h.remove()
    return out


def serve_reading(cfg, traffic, seed, device, kind):
    t = dict(traffic, model_options=INT8) if kind == 'control_int8' \
        else traffic
    b = serve.build(cfg, t, seed, device)
    samples = serve_samples(b, seed)
    ref, rcfg, sizes = b['ref'], b['rcfg'], b['sizes']
    del b
    torch.cuda.empty_cache()
    img = (traffic['size'],) * 2
    nums, live = check.serve_numbers(samples, ref, rcfg, sizes, img,
                                     control=kind == 'control_ref')
    yield kind, nums, {'live_mean': sum(live) / len(live)}


def train_reading(cfg, traffic, seed, device, kind):
    ctx = dict(cfg=cfg, traffic=traffic, seed=seed, device=device)
    rcfg = common.reference_config(cfg, traffic)
    k = traffic['check_steps']
    if kind == 'program':
        p = train.prepare(ctx)
        prog, state, names, pool = p['prog'], p['state'], p['names'], \
            p['pool']
        del p
        torch.cuda.empty_cache()
        ref = train.reference_steps(rcfg, cfg['optimizer'], state,
                                    pool[:k], names, device,
                                    rois=prog['rois'])
        nums, leaves = check.train_numbers(prog, ref, names)
        yield kind, nums, dict(leaves, losses=prog['losses'],
                               ref_losses=ref['losses'])
        return
    from portbench.reference.model import Detector
    names = [n for n, _ in Detector(rcfg).named_parameters()]
    state = common.seeded_state(Detector(rcfg),
                                common.derive_seed(seed, 1), device)
    pool = train.pool_batches(traffic, cfg['num_classes'], seed, device)
    batches = pool[:k]
    runs = [(f'control_{q}', dict(quant=q)) for q in ('int8', 'fp8')] + \
        [('fault_half_batch',
          dict(keep=max(1, batches[0]['image'].shape[0] // 2)))]
    for what, kw in runs:
        side = train.reference_steps(rcfg, cfg['optimizer'], state,
                                     batches, names, device, **kw)
        ref = train.reference_steps(rcfg, cfg['optimizer'], state, batches,
                                    names, device, rois=side['rois'])
        nums, leaves = check.train_numbers(side, ref, names)
        yield what, nums, dict(leaves, losses=side['losses'],
                               ref_losses=ref['losses'])


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--out', default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print('readings: no CUDA card', file=sys.stderr)
        return 2
    man = Manifest()
    cell = man.cell(args.workload)
    cfg = man.config(cell['config'])
    traffic = man.traffic(cell['traffic'])
    limits = man.limits(args.workload).get('numbers', {})
    device = torch.device('cuda', 0)
    fn = serve_reading if traffic['mode'] == 'serve' else train_reading
    out = open(args.out, 'a') if args.out else None
    card = common.card_info(device)
    jobs = [(int(s), 'program') for s in args.seeds.split(',') if s] + \
        [(int(s), 'control') for s in args.control_seeds.split(',') if s]
    for seed, kind in jobs:
        t = time.perf_counter()
        kinds = ['control_ref', 'control_int8'] \
            if kind == 'control' and fn is serve_reading else [kind]
        for what, nums, extra in (r for k in kinds
                                  for r in fn(cfg, traffic, seed, device, k)):
            judged = evaluate(nums, limits)
            line = json.dumps(dict(workload=args.workload, seed=seed,
                                   kind=what, numbers=nums, card=card,
                                   correct=all(ok for *_, ok in judged),
                                   seconds=time.perf_counter() - t, **extra))
            print(line, flush=True)
            if out:
                out.write(line + '\n')
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
