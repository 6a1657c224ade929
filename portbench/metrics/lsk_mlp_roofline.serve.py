"""The LSKNet MLP sub-blocks' share of their roofline (%): the least time
of a step's MLP sub-blocks (``work/lsknet.py``: one fused pass a block)
over their device time (``lsk_mlp_ms.serve``'s reading). Nothing to read
from a program without the spans."""
from portbench.bench import span_device
from portbench.work import lsknet


def read(run):
    ms = span_device.inside_ms(run, 'r3det.backbone.lsk.mlp')
    if not ms:
        return None
    tr = run['traffic']
    least = lsknet.least_s(run['cfg'], 'mlp', tr['batch'], tr['size'],
                           tr['size'])
    return 100.0 * least * 1e3 / ms
