"""Statistics of the train CLI's ``train_log.jsonl``, and loss curves.

    python -m r3det_tpu_torch.tools.analyze_logs cal_train_time LOG [LOG ...]
    python -m r3det_tpu_torch.tools.analyze_logs plot_curve LOG [LOG ...] \
        [--keys total] [--out curve.png]

Port of ``tools/analysis_tools/analyze_logs.py``. ``cal_train_time``
prints the JAX tool's throughput line (mean, fastest and slowest
``imgs_per_sec`` over the train records), then each loss's first, last,
least and mean value and the validation records' metrics. ``plot_curve``
alone draws, and needs matplotlib; the statistics do not.
"""
import argparse
import json

import numpy as np


def load_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def throughput(recs):
    """(mean, fastest, slowest, records) of the train records'
    ``imgs_per_sec``, or None when there are none."""
    ips = np.array([r['imgs_per_sec'] for r in recs if 'imgs_per_sec' in r])
    if not len(ips):
        return None
    return float(ips.mean()), float(ips.max()), float(ips.min()), len(ips)


def loss_summary(recs):
    """{loss key: (first, last, least, mean)} over the train records."""
    train = [r for r in recs if 'imgs_per_sec' in r]
    keys = [k for k in (train[0] if train else {})
            if k not in ('step', 'imgs_per_sec', 'lr')]
    out = {}
    for k in keys:
        v = np.array([r[k] for r in train if k in r], np.float64)
        out[k] = (float(v[0]), float(v[-1]), float(v.min()), float(v.mean()))
    return out


def cmd_time(args):
    for path in args.json_logs:
        recs = load_log(path)
        stats = throughput(recs)
        if stats is None:
            print(f'{path}: no throughput records')
            continue
        mean, fastest, slowest, n = stats
        print(f'{path}: mean {mean:.2f} img/s  '
              f'fastest {fastest:.2f}  slowest {slowest:.2f}  '
              f'({n} records)')
        for k, (first, last, least, avg) in loss_summary(recs).items():
            print(f'  {k}: first {first:.4f}  last {last:.4f}  '
                  f'min {least:.4f}  mean {avg:.4f}')
        for r in recs:
            if r.get('mode') == 'val':
                print(f'  val @ step {r["step"]}: ' + '  '.join(
                    f'{k}={v:.4f}' for k, v in r.items()
                    if k not in ('step', 'mode')))


def cmd_plot(args):
    try:
        import matplotlib
    except ImportError:
        raise SystemExit('plot_curve needs matplotlib, which is not '
                         'installed; cal_train_time does not')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for path in args.json_logs:
        recs = load_log(path)
        for key in args.keys:
            xs = [r['step'] for r in recs if key in r]
            ys = [r[key] for r in recs if key in r]
            plt.plot(xs, ys, label=f'{path}:{key}')
    plt.xlabel('step')
    plt.legend()
    plt.savefig(args.out)
    print(f'plot -> {args.out}')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Analyze train logs')
    sub = p.add_subparsers(dest='cmd', required=True)
    pp = sub.add_parser('plot_curve')
    pp.add_argument('json_logs', nargs='+')
    pp.add_argument('--keys', nargs='+', default=['total'])
    pp.add_argument('--out', default='curve.png')
    pt = sub.add_parser('cal_train_time')
    pt.add_argument('json_logs', nargs='+')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    {'plot_curve': cmd_plot, 'cal_train_time': cmd_time}[args.cmd](args)


if __name__ == '__main__':
    main()
