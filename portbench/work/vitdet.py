"""The least work of the ViT backbone's sub-blocks, and its least time on
one H100 SXM: the yardsticks of ``vit_window_attn_roofline`` and
``vit_global_attn_roofline``, and of the MLP.

Three kinds of sub-block, each from its norm through its residual add, as
the spans cut them (``backbone.vit.window_attn``, ``.global_attn``,
``.mlp``):

- attention: ``x + proj(Attn(norm1(x)))``, over the window-padded grid
  in a window block (its qkv and proj products included), over the whole
  grid in a global block;
- MLP: ``x + fc2(GELU(fc1(norm2(x))))``.

Tensor-core operations in bf16 (a multiply-add is two): the qkv, proj,
fc1 and fc2 products, q.k^T and P.v, and the two relative-position
einsums (each query against the key rows and the key columns of its
grid). Bytes in bf16, as a pipeline of products whose epilogues hold the
norm, the biases, GELU and the residual, with a flash-style attention
that keeps no logits in memory: the sub-block's input read once and its
output written once; each product's output written once and read once by
the next (q, k and v; the attention's output; the MLP's hidden); every
weight, bias, norm and relative table read once. The least time of a
sub-block is the larger of its product time at 989 TFLOP/s and its byte
time at 3.35 TB/s; the sub-blocks run one after another, so their times
add.

At ViT-B's widths, batch 8 of 1024^2 (``bound_by``): the products bound
all three; least times 0.580 ms a global sub-block, 0.213 a window
sub-block and 0.313 an MLP sub-block.
"""
from .kernels import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16 = 2                    # bytes
PARTS = ('window_attn', 'global_attn', 'mlp')
RESOURCES = ('bytes', 'tensor')


def _padded(n, window):
    return n + (window - n % window) % window


def sub_block(cfg, part, batch, h, w):
    """One ``part`` sub-block of a batch of ``h`` x ``w`` images: (bytes,
    tensor-core operations)."""
    c = cfg['vit_embed_dim']
    p = cfg['vit_patch_size']
    heads = cfg['vit_num_heads']
    d = c // heads
    gh, gw = h // p, w // p
    tokens = batch * gh * gw
    io = 2 * tokens * c                              # input and output
    if part == 'mlp':
        hidden = int(c * cfg['vit_mlp_ratio'])
        weights = 2 * c + c * hidden + hidden + hidden * c + c
        return (BF16 * (io + 2 * tokens * hidden + weights),
                2 * 2 * tokens * c * hidden)
    if part == 'global_attn':
        hp, wp, qh, qw = gh, gw, gh, gw
    else:
        win = cfg['vit_window_size']
        hp, wp = _padded(gh, win), _padded(gw, win)
        qh = qw = win
    padded = batch * hp * wp                         # qkv and proj rows
    n = qh * qw
    grids = padded // n
    weights = 2 * c + 3 * c * c + 3 * c + c * c + c + (2 * qh - 1 + 2 * qw
                                                       - 1) * d
    macs = (padded * 4 * c * c                       # qkv, proj
            + 2 * grids * heads * n * n * d          # q.k^T, P.v
            + grids * heads * n * (qh + qw) * d)     # relative terms
    nbytes = BF16 * (io + 2 * padded * 3 * c + 2 * padded * c + weights)
    return nbytes, 2 * macs


def count(cfg, part):
    """How many ``part`` sub-blocks a forward runs."""
    glob = sum(i in cfg['vit_global_blocks'] for i in range(cfg['vit_depth']))
    return {'window_attn': cfg['vit_depth'] - glob, 'global_attn': glob,
            'mlp': cfg['vit_depth']}[part]


def times(block):
    """A sub-block's seconds on each resource, in ``RESOURCES``' order."""
    nbytes, tensor = block
    return nbytes / HBM_BYTES_PER_S, tensor / PEAK_OPS_PER_S['bf16']


def least_s(cfg, part, batch, h, w):
    """The least seconds of all the ``part`` sub-blocks of one batch."""
    return count(cfg, part) * max(times(sub_block(cfg, part, batch, h, w)))


def bound_by(cfg, part, batch, h, w):
    """The resource that bounds a ``part`` sub-block."""
    t = times(sub_block(cfg, part, batch, h, w))
    return RESOURCES[t.index(max(t))]
