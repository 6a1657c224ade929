"""The ``vitdet`` backbone's products, for ``work/flops.py``: the patch
embedding conv; in each block the qkv and proj linears (over the
window-padded grid in a window block), q.k^T and P.v (over each window,
or over the whole grid in a global block), the two relative-position
einsums (each query against every key row and every key column of its
grid: Hq Wq (Hk + Wk) d a head), fc1 and fc2 over the unpadded grid; and
the pyramid's 2x2/s2 transposed conv. The max-pooled level has no
product. Sizes from the ``vit_*`` keys, as ``reference/backbones/vitdet.py``
builds it.

Every op trains (the configuration freezes nothing); q.k^T, P.v and the
relative einsums have no weight, and their two input gradients take the
places of the weight and the input gradient in ``flops.train_flops``.
Only the image takes no gradient.
"""


def _padded(n, window):
    return n + (window - n % window) % window


def ops(cfg, h, w):
    """Every product as (name, MACs, trainable, input_grad), and the
    output channels of the three pyramid levels."""
    c = cfg['vit_embed_dim']
    p = cfg['vit_patch_size']
    heads = cfg['vit_num_heads']
    d = c // heads
    hidden = int(c * cfg['vit_mlp_ratio'])
    win = cfg['vit_window_size']
    gh, gw = h // p, w // p
    out = [('patch_embed.proj', gh * gw * 3 * p * p * c, True, False)]
    for i in range(cfg['vit_depth']):
        name = f'blocks.{i}'
        if i in cfg['vit_global_blocks']:
            hp, wp = gh, gw
            grids, qh, qw = 1, gh, gw
        else:
            hp, wp = _padded(gh, win), _padded(gw, win)
            grids, qh, qw = (hp // win) * (wp // win), win, win
        n = qh * qw
        attn = grids * heads * n * n * d
        out += [(name + '.attn.qkv', hp * wp * c * 3 * c, True, True),
                (name + '.attn.qk', attn, True, True),
                (name + '.attn.rel_pos', grids * heads * n * (qh + qw) * d,
                 True, True),
                (name + '.attn.av', attn, True, True),
                (name + '.attn.proj', hp * wp * c * c, True, True),
                (name + '.mlp.fc1', gh * gw * c * hidden, True, True),
                (name + '.mlp.fc2', gh * gw * hidden * c, True, True)]
    out.append(('simfp_3.0', gh * gw * c * (c // 2) * 4, True, True))
    return out, (c // 2, c, c)
