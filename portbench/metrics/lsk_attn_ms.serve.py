"""Device ms a predict step in the LSKNet backbone's attention sub-blocks:
the device ops inside the GPU copies of the program's
``r3det.backbone.lsk.attn`` ranges (``norm1`` through the residual add,
one a block), in the program-traced sub-window. Nothing to read from a
program without those spans."""
from portbench.bench import span_device


def read(run):
    return span_device.inside_ms(run, 'r3det.backbone.lsk.attn')
