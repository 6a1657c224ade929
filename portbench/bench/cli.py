"""``run.py``'s body: one cell, one run, one JSON line.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell names its configuration and traffic mix in ``BENCHMARK.json``;
the mix's ``mode`` names the driver (``bench/<mode>.py``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``metrics/<name>.py``), read from a
traced sub-window after the untraced window. Without enough cards the run
prints no result and exits 2; with JAX or the JAX package loaded it exits
3. Each number that decides ``correct`` is printed beside its limit as the
last lines on standard error and under the line's last key, ``checks``.
"""
import argparse
import importlib
import sys

from . import common
from .manifest import Manifest


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def evaluate(numbers, limits):
    """[(name, value, limit, ok)] of the numbers the cell's limits file
    names; a number the run did not give fails, and so does a cell with
    no limit."""
    out = [(n, numbers.get(n, float('nan')), lim['limit'],
            numbers.get(n, float('nan')) <= lim['limit'])
           for n, lim in limits.items()]
    return out or [('limits', float('nan'), None, False)]


def main(argv, t0):
    import torch
    args = parse(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    chips = cell['chips']
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f'portbench: {args.workload} needs {chips} CUDA card(s); '
              f'this machine has {have}', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    out = execute(man, cell, args.seed, args.seconds, args.trace, device, t0)
    found = common.forbidden_modules()
    if found:
        print(f'portbench: forbidden modules loaded: {found}',
              file=sys.stderr)
        return 3
    for n, c in out['checks'].items():
        print(f"[check] {n}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    common.emit(out)
    return 0


def execute(man, cell, seed, seconds, trace, device, t0):
    """Run ``cell`` on ``device``: the result line's dict."""
    import torch
    cfg = man.config(cell['config'])
    traffic = man.traffic(cell['traffic'])
    ctx = dict(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
               trace=trace, device=device, t0=t0)
    mode = importlib.import_module(f'portbench.bench.{traffic["mode"]}')
    res = mode.run(ctx)
    name = cell['name']
    if device.type == 'cuda':
        common.log('card', name=common.card_info(device),
                   peak_bf16_flops=common.PEAK_BF16)
    metrics, extra = {}, {}
    if trace:
        run = dict(res['layer'], cfg=cfg, traffic=traffic, res=res)
        for m in man.per_layer(name):
            v = man.reader(m)(run)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        tr = res['layer']['trace']
        extra = {'busy_s': tr.busy_s(), 'window_s': tr.window_s}
    else:
        for m in man.end_to_end(name):
            metrics[m['name']] = {'value': res['e2e'][m['name']],
                                  'unit': m['unit']}
    common.log('numbers', **res['numbers'])
    checks = evaluate(res['numbers'], man.limits(name).get('numbers', {}))
    correct = res['failed'] == 0 and all(ok for *_, ok in checks)
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' \
        else 'cpu'
    out = {'correct': correct, 'attempted': res['attempted'],
           'failed': res['failed'], 'metrics': metrics,
           'device': dict(platform='gpu' if device.type == 'cuda' else 'cpu',
                          kind=kind, count=cell['chips'],
                          memory_peak_bytes=res['memory_peak_bytes'],
                          **extra)}
    if trace:
        out['breakdown'] = res['layer']['trace'].breakdown()
    out['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim, _ in checks}
    return out
