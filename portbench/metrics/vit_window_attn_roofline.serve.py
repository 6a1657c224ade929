"""The ViT's window-attention sub-blocks' share of their roofline (%):
the least time of a step's window-attention sub-blocks
(``work/vitdet.py``: the products at the bf16 peak, or their bytes at
the HBM rate, whichever is larger) over their device time
(``vit_window_attn_ms.serve``'s reading). Nothing to read from a program
without the spans."""
from portbench.bench import span_device
from portbench.work import vitdet


def read(run):
    ms = span_device.inside_ms(run, 'r3det.backbone.vit.window_attn')
    if not ms:
        return None
    tr = run['traffic']
    least = vitdet.least_s(run['cfg'], 'window_attn', tr['batch'],
                           tr['size'], tr['size'])
    return 100.0 * least * 1e3 / ms
