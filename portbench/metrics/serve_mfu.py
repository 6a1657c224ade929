"""The predict step's share of the card's bf16 peak (%): the forward
FLOPs of the configuration (``work/flops.py``) times the patches served in
the untraced window, over its seconds and 989 TFLOP/s (H100 SXM)."""
from portbench.bench.common import PEAK_BF16
from portbench.work import flops


def read(run):
    res, tr = run['res'], run['traffic']
    f = flops.forward_flops(run['cfg'], tr['size'])
    return 100.0 * f * res['steps'] * tr['batch'] / res['window_s'] / PEAK_BF16
