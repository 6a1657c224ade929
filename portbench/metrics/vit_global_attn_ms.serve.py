"""Device ms a predict step in the ViT backbone's global-attention
sub-blocks (``norm1`` through the residual add, four a ViT-B forward):
the device ops inside the GPU copies of the program's
``r3det.backbone.vit.global_attn`` ranges, in the program-traced
sub-window. Nothing to read from a program without those spans."""
from portbench.bench import span_device


def read(run):
    return span_device.inside_ms(run, 'r3det.backbone.vit.global_attn')
