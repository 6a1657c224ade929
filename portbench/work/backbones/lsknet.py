"""The ``lsknet`` backbone's convs, for ``work/flops.py``: each stage's patch
embedding (a 7x7/s4 conv on the image, then 3x3/s2 convs) and in each
block the 1x1 convs (``proj_1``, ``proj_2``; the selection's ``conv1``,
``conv2`` and ``conv``; the MLP's ``fc1`` and ``fc2``), the depthwise
taps (``conv0`` 5x5, ``conv_spatial`` 7x7 of dilation 3, the MLP's 3x3
``dwconv``) and the dense 2 -> 2 channel 7x7 ``conv_squeeze``. Sizes from
the ``lsk_*`` keys, as ``reference/backbones/lsknet.py`` builds it; a
depthwise conv's MACs are its taps, one a channel and tap.

Every op trains (LSKNet freezes nothing); only the image takes no
gradient.
"""


def _out(n, k, stride, pad):
    return (n + 2 * pad - k) // stride + 1


def ops(cfg, h, w):
    """Every conv as (name, MACs, trainable, input_grad), and the output
    channels of the four stages."""
    dims = cfg['lsk_embed_dims']
    out = []
    hs, ws, cin = h, w, 3
    for i, (c, depth, ratio) in enumerate(zip(dims, cfg['lsk_depths'],
                                              cfg['lsk_mlp_ratios'])):
        k, s = (7, 4) if i == 0 else (3, 2)
        hs, ws = _out(hs, k, s, k // 2), _out(ws, k, s, k // 2)
        pos = hs * ws
        out.append((f'patch_embed{i + 1}', pos * cin * c * k * k, True,
                    i > 0))
        hid = int(c * ratio)
        for j in range(depth):
            name = f'block{i + 1}.{j}'
            sgu = name + '.attn.spatial_gating_unit'
            out += [(name + '.attn.proj_1', pos * c * c, True, True),
                    (sgu + '.conv0', pos * c * 25, True, True),
                    (sgu + '.conv_spatial', pos * c * 49, True, True),
                    (sgu + '.conv1', pos * c * (c // 2), True, True),
                    (sgu + '.conv2', pos * c * (c // 2), True, True),
                    (sgu + '.conv_squeeze', pos * 2 * 2 * 49, True, True),
                    (sgu + '.conv', pos * (c // 2) * c, True, True),
                    (name + '.attn.proj_2', pos * c * c, True, True),
                    (name + '.mlp.fc1', pos * c * hid, True, True),
                    (name + '.mlp.dwconv', pos * hid * 9, True, True),
                    (name + '.mlp.fc2', pos * hid * c, True, True)]
        cin = c
    return out, tuple(dims)
