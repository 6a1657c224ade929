"""The Swin window-attention sub-blocks' share of their roofline (%): the
least time of a step's attention sub-blocks (``work/swin.py``: one fused
bf16 pass a block) over their device time (``swin_attn_ms.serve``'s
reading). Nothing to read from a program without the spans."""
from portbench.bench import span_device
from portbench.work import swin


def read(run):
    ms = span_device.inside_ms(run, 'r3det.backbone.swin.attn')
    if not ms:
        return None
    tr = run['traffic']
    least = swin.attn_least_s(run['cfg'], tr['batch'], tr['size'],
                              tr['size'])
    return 100.0 * least * 1e3 / ms
