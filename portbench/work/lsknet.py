"""The least work of the LSKNet backbone's sub-blocks, and its least time on
one H100 SXM: the yardsticks of ``lsk_attn_roofline`` and
``lsk_mlp_roofline``.

Two sub-blocks a block, each as one fused pass would do it, whatever the
program launches:

- attention (the ``backbone.lsk.attn`` span): ``norm1`` through the
  residual add, ``x + layer_scale_1 * (proj_2(LSK(GELU(proj_1(u)))) +
  u)`` with ``u = norm1(x)``;
- MLP (``backbone.lsk.mlp``): ``norm2`` through its residual add, ``x +
  layer_scale_2 * fc2(GELU(dwconv(fc1(norm2(x)))))``.

Bytes: the sub-block's input read once and its output written once in
bf16, and its weights (BN folded to a scale and a shift, the convs with
their biases, the layer scale) read once in bf16. Tensor-core operations:
the 1x1 products in bf16 (a multiply-add is two). CUDA-core operations in
float32, each multiply-add two and every other operation one: the
depthwise taps and the 2 -> 2 channel ``conv_squeeze``, the BN's affine,
the convs' bias adds, GELU (``GELU_OPS`` an element, fewer than any erf
takes), the channel mean and max, the sigmoid (``SIGMOID_OPS``), the
selection's weighted sum, the gate's product, the shortcut add and the
layer-scaled residual. Its least time is the largest of the three
resources' times; the sub-blocks run one after another, so their times
add.

At LSKNet-S's widths and 1024^2 (``bound_by``) the CUDA cores bound the
attention of stages 1-3 (its taps: 74 a channel) and the MLP of stage 1
(9 taps a hidden channel), the tensor cores the other sub-blocks.
"""
from .kernels import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16 = 2                    # bytes
GELU_OPS = 8
SIGMOID_OPS = 4
RESOURCES = ('bytes', 'tensor', 'f32')


def attn_work(c):
    """One attention sub-block of C channels: (bytes a position, weight
    bytes, tensor-core operations a position, float32 operations a
    position)."""
    half = c // 2
    weights = (2 * c                              # norm1, folded
               + c * c + c                        # proj_1
               + 26 * c + 50 * c                  # conv0, conv_spatial
               + 2 * (c * half + half)            # conv1, conv2
               + 2 * 2 * 49 + 2                   # conv_squeeze
               + half * c + c                     # conv
               + c * c + c                        # proj_2
               + c)                               # layer_scale_1
    tensor = 2 * (c * c + 2 * c * half + half * c + c * c)
    f32 = (2 * c                                  # norm1
           + c + 2 * half + c + c                 # 1x1 biases
           + GELU_OPS * c
           + 2 * 74 * c + 2 * c                   # taps and their biases
           + 2 * c                                # mean and max
           + 2 * 2 * 2 * 49 + 2                   # conv_squeeze
           + 2 * SIGMOID_OPS
           + 3 * half                             # b1 * s0 + b2 * s1
           + c + c                                # v * conv(m), + u
           + 2 * c)                               # x + ls1 * y
    return 2 * BF16 * c, BF16 * weights, tensor, f32


def mlp_work(c, hidden):
    """One MLP sub-block of C channels and ``hidden`` hidden ones, as
    :func:`attn_work`."""
    weights = (2 * c                              # norm2, folded
               + c * hidden + hidden              # fc1
               + 10 * hidden                      # dwconv
               + hidden * c + c                   # fc2
               + c)                               # layer_scale_2
    tensor = 2 * 2 * c * hidden
    f32 = (2 * c                                  # norm2
           + hidden                               # fc1's bias
           + 2 * 9 * hidden + hidden              # dwconv
           + GELU_OPS * hidden
           + c                                    # fc2's bias
           + 2 * c)                               # x + ls2 * y
    return 2 * BF16 * c, BF16 * weights, tensor, f32


def stages(cfg, h, w):
    """Each stage's (positions an image, channels, hidden channels,
    depth)."""
    out = []
    for i, (c, depth, ratio) in enumerate(zip(
            cfg['lsk_embed_dims'], cfg['lsk_depths'],
            cfg['lsk_mlp_ratios'])):
        k, s = (7, 4) if i == 0 else (3, 2)
        h = (h + 2 * (k // 2) - k) // s + 1
        w = (w + 2 * (k // 2) - k) // s + 1
        out.append((h * w, c, int(c * ratio), depth))
    return out


def stage_blocks(cfg, part, batch, h, w):
    """Each stage's ``part`` ('attn' or 'mlp') sub-block of a batch of
    ``h`` x ``w`` images, (bytes, tensor-core operations, float32
    operations), and the stage's depth."""
    out = []
    for pos, c, hidden, depth in stages(cfg, h, w):
        n = batch * pos
        act, weights, tensor, f32 = attn_work(c) if part == 'attn' \
            else mlp_work(c, hidden)
        out.append(((n * act + weights, n * tensor, n * f32), depth))
    return out


def blocks(cfg, part, batch, h, w):
    """Every ``part`` sub-block of a batch, in order."""
    return [b for b, depth in stage_blocks(cfg, part, batch, h, w)
            for _ in range(depth)]


def times(block):
    """A sub-block's seconds on each resource, in ``RESOURCES``' order."""
    nbytes, tensor, f32 = block
    return (nbytes / HBM_BYTES_PER_S, tensor / PEAK_OPS_PER_S['bf16'],
            f32 / PEAK_OPS_PER_S['f32'])


def least_s(cfg, part, batch, h, w):
    """The least seconds of all the ``part`` sub-blocks of one batch."""
    return sum(max(times(b)) for b in blocks(cfg, part, batch, h, w))


def bound_by(cfg, part, batch, h, w):
    """The resource that bounds each stage's ``part`` sub-blocks."""
    out = []
    for block, _ in stage_blocks(cfg, part, batch, h, w):
        t = times(block)
        out.append(RESOURCES[t.index(max(t))])
    return out
