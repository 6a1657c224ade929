"""Device ms a predict step in the ViT backbone's MLP sub-blocks
(``norm2`` through the residual add, one a block): the device ops inside
the GPU copies of the program's ``r3det.backbone.vit.mlp`` ranges, in
the program-traced sub-window. Nothing to read from a program without
those spans."""
from portbench.bench import span_device


def read(run):
    return span_device.inside_ms(run, 'r3det.backbone.vit.mlp')
