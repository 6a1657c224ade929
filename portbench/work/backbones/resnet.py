"""The ``resnet`` backbone's convs, for ``work/flops.py``: the 7x7/s2 stem
and the bottlenecks with the stride on the 3x3 conv, sized by
``backbone_depth``.

With ``frozen_stages`` = k the stem and stages 1..k are frozen and nothing
flows back into them, so the first trainable stage's first block takes no
input gradient on its conv1 and downsample.
"""
import math

BLOCKS = {10: (1, 1, 1, 1), 14: (2, 1, 1, 1), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3)}
WIDTHS = (64, 128, 256, 512)


def _out(n, stride):
    return math.ceil(n / stride)


def ops(cfg, h, w):
    """Every conv as (name, MACs, trainable, input_grad), and the output
    channels of C2-C5."""
    out = []
    frozen = cfg['frozen_stages']
    hs, ws = _out(h, 2), _out(w, 2)
    out.append(('stem', hs * ws * 64 * 7 * 7 * 3, frozen < 0, False))
    hs, ws = _out(hs, 2), _out(ws, 2)
    cin = 64
    for s, n in enumerate(BLOCKS[cfg['backbone_depth']]):
        f = WIDTHS[s]
        train = s >= frozen
        for b in range(n):
            st = 2 if b == 0 and s > 0 else 1
            ho, wo = _out(hs, st), _out(ws, st)
            first = b == 0 and s == frozen
            grad_in = train and not first
            name = f'layer{s + 1}_{b}'
            out.append((name + '.conv1', hs * ws * cin * f, train, grad_in))
            out.append((name + '.conv2', ho * wo * f * f * 9, train, train))
            out.append((name + '.conv3', ho * wo * f * 4 * f, train, train))
            if cin != 4 * f or st != 1:
                out.append((name + '.downsample', ho * wo * cin * 4 * f,
                            train, grad_in))
            cin, hs, ws = 4 * f, ho, wo
    return out, tuple(4 * f for f in WIDTHS)
