"""The train step's share of the card's bf16 peak (%): forward and
backward FLOPs of the configuration (``work/flops.py``, frozen stages
without gradients) times the images of the untraced window, over its
seconds and 989 TFLOP/s (H100 SXM)."""
from portbench.bench.common import PEAK_BF16
from portbench.work import flops


def read(run):
    res, tr = run['res'], run['traffic']
    f = flops.train_flops(run['cfg'], tr['size'])
    images = res['steps'] * tr['batch']
    return 100.0 * f * images / res['window_s'] / PEAK_BF16
