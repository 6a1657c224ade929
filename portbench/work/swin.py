"""The least work of the Swin backbone's window-attention sub-blocks (the
``backbone.swin.attn`` span: ``norm1`` through the residual add), and its
least time on one H100 SXM: the yardstick of ``swin_attn_roofline``.

The bound is that of one fused pass a block, whatever the program
launches: the block's input read once and its output written once in
bf16, the block's weights (``norm1``, qkv and proj, with their biases) and
its bias table read once in bf16; the qkv and proj products over the
window-padded map, QK^T and AV over its windows on the tensor cores in
bf16, and the softmax (the bias and mask add, the max, the exponential,
the sum and the division: ``SOFTMAX_OPS`` an element) in float32 on the
CUDA cores. Its least time is the largest of the three resources' times;
the blocks run one after another, so their times add.
"""
import math

from .kernels import HBM_BYTES_PER_S, PEAK_OPS_PER_S

SOFTMAX_OPS = 5             # f32 operations a score: add, max, exp, sum, div
BF16 = 2                    # bytes


def _padded(n, window):
    return n + (window - n % window) % window


def attn_blocks(cfg, batch, h, w):
    """Each attention sub-block of a batch of ``h`` x ``w`` images, in
    order: (bytes, tensor-core operations, float32 operations)."""
    c = cfg['swin_embed_dims']
    ws = cfg['swin_window_size']
    p = cfg['swin_patch_size']
    hs, wd = math.ceil(h / p), math.ceil(w / p)
    out = []
    depths = cfg['swin_depths']
    for i, (depth, heads) in enumerate(zip(depths, cfg['swin_num_heads'])):
        hp, wp = _padded(hs, ws), _padded(wd, ws)
        n = ws * ws
        scores = batch * (hp // ws) * (wp // ws) * heads * n * n
        macs = batch * hp * wp * (3 * c * c + c * c) \
            + 2 * scores * (c // heads)
        weights = 2 * c + 3 * c * c + 3 * c + c * c + c \
            + (2 * ws - 1) ** 2 * heads
        nbytes = BF16 * (2 * batch * hs * wd * c + weights)
        out += [(nbytes, 2 * macs, SOFTMAX_OPS * scores)] * depth
        if i < len(depths) - 1:
            hs, wd, c = math.ceil(hs / 2), math.ceil(wd / 2), 2 * c
    return out


def attn_least_s(cfg, batch, h, w):
    """The least seconds of all the attention sub-blocks of one batch."""
    return sum(max(nbytes / HBM_BYTES_PER_S, tc / PEAK_OPS_PER_S['bf16'],
                   f32 / PEAK_OPS_PER_S['f32'])
               for nbytes, tc, f32 in attn_blocks(cfg, batch, h, w))
