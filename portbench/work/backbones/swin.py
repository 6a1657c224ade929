"""The ``swin`` backbone's matrix products, for ``work/flops.py``: the
patch embedding conv, and in each block the qkv and proj linears over the
window-padded map, QK^T and AV over its windows, fc1 and fc2 over the
unpadded map; each merge's reduction over the half map (padded to even
sides). Sizes from the ``swin_*`` keys, as ``reference/backbones/swin.py``
builds it.

Every op trains (the configuration freezes nothing); QK^T and AV have no
weight, and their two input gradients take the places of the weight and
the input gradient in ``flops.train_flops``. Only the image takes no
gradient.
"""
import math


def _padded(n, window):
    return n + (window - n % window) % window


def ops(cfg, h, w):
    """Every product as (name, MACs, trainable, input_grad), and the
    output channels of the ``swin_out_indices`` stages."""
    c = cfg['swin_embed_dims']
    ws = cfg['swin_window_size']
    ratio = cfg['swin_mlp_ratio']
    p = cfg['swin_patch_size']
    hs, wd = math.ceil(h / p), math.ceil(w / p)
    out = [('patch_embed', hs * wd * 3 * p * p * c, True, False)]
    depths = cfg['swin_depths']
    for i, (depth, heads) in enumerate(zip(depths, cfg['swin_num_heads'])):
        hp, wp = _padded(hs, ws), _padded(wd, ws)
        windows = (hp // ws) * (wp // ws)
        n = ws * ws
        for b in range(depth):
            name = f'stages.{i}.blocks.{b}'
            attn = windows * heads * n * n * (c // heads)
            out += [(name + '.qkv', hp * wp * c * 3 * c, True, True),
                    (name + '.qk', attn, True, True),
                    (name + '.av', attn, True, True),
                    (name + '.proj', hp * wp * c * c, True, True),
                    (name + '.fc1', hs * wd * c * ratio * c, True, True),
                    (name + '.fc2', hs * wd * ratio * c * c, True, True)]
        if i < len(depths) - 1:
            hs, wd = math.ceil(hs / 2), math.ceil(wd / 2)
            out.append((f'stages.{i}.downsample', hs * wd * 4 * c * 2 * c,
                        True, True))
            c *= 2
    chans = tuple(cfg['swin_embed_dims'] * 2 ** i
                  for i in cfg['swin_out_indices'])
    return out, chans
