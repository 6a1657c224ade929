"""Device ms a predict step in the LSKNet backbone's MLP sub-blocks
(``norm2``, fc1, the depthwise 3x3, GELU, fc2 and the residual add): the
device ops inside the GPU copies of the program's
``r3det.backbone.lsk.mlp`` ranges, in the program-traced sub-window.
Nothing to read from a program without those spans."""
from portbench.bench import span_device


def read(run):
    return span_device.inside_ms(run, 'r3det.backbone.lsk.mlp')
