"""FLOPs of a detector step, counted from the configuration's layer shapes.

Every convolution of the published architecture at an H x W input:
ResNet (the 7x7/s2 stem, the bottlenecks with the stride on the 3x3
conv), the FPN (laterals on C3-C5, 3x3 outputs, P6 and P7 on C5), the
retina head's towers and predictors on each level, and, for R3Det, each
refine stage's FRM (1x5, 5x1 and 1x1 convs) and refine head. One
multiply-add is two FLOPs. Element-wise work (BN, ReLU, the sample,
decode, NMS, losses) is left out: it is a rounding error beside the convs
and would not change with the program's kernels either.

A training step adds the backward: a weight gradient for every trainable
conv, and an input gradient for every conv whose input carries one. With
``frozen_stages`` = k the stem and stages 1..k are frozen and nothing flows
back into them, so the first trainable stage's first block takes no input
gradient on its conv1 and downsample.
"""
import math

BLOCKS = {10: (1, 1, 1, 1), 14: (2, 1, 1, 1), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3)}
WIDTHS = (64, 128, 256, 512)


def _out(n, stride):
    return math.ceil(n / stride)


def convs(cfg, h, w):
    """Every conv as (name, MACs, trainable, input_grad)."""
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
    ch = cfg['feat_channels']
    sizes = [(_out(h, s), _out(w, s)) for s in cfg['strides']]
    for i, c in enumerate((512, 1024, 2048)):
        lh, lw = sizes[i]
        out.append((f'neck.lateral_{i}', lh * lw * c * ch, True, True))
        out.append((f'neck.fpn_{i}', lh * lw * ch * ch * 9, True, True))
    out.append(('neck.extra_0', sizes[3][0] * sizes[3][1] * 2048 * ch * 9,
                True, True))
    out.append(('neck.extra_1', sizes[4][0] * sizes[4][1] * ch * ch * 9,
                True, True))
    na = len(cfg['ratios']) * cfg['scales_per_octave']
    heads = [('bbox_head', cfg['stacked_convs'], na)]
    for i in range(cfg['num_refine_stages']):
        heads.append((f'frm_{i}', None, None))
        heads.append((f'refine_head_{i}', cfg.get('refine_stacked_convs')
                      or cfg['stacked_convs'], 1))
    for name, stacked, a in heads:
        for lvl, (lh, lw) in enumerate(sizes):
            pos = lh * lw
            if stacked is None:                       # FRM: 1x5, 5x1, 1x1
                out.append((f'{name}.{lvl}', pos * ch * ch * 11, True, True))
                continue
            out.append((f'{name}.towers.{lvl}',
                        2 * stacked * pos * ch * ch * 9, True, True))
            out.append((f'{name}.cls.{lvl}',
                        pos * ch * a * cfg['num_classes'] * 9, True, True))
            out.append((f'{name}.reg.{lvl}', pos * ch * a * 5 * 9, True,
                        True))
    return out


def forward_flops(cfg, h, w=None):
    """FLOPs of one image's forward pass."""
    return 2 * sum(m for _, m, _, _ in convs(cfg, h, w or h))


def train_flops(cfg, h, w=None):
    """FLOPs of one image's forward and backward pass."""
    total = 0
    for _, m, train, grad_in in convs(cfg, h, w or h):
        total += m + (m if train else 0) + (m if grad_in else 0)
    return 2 * total
