"""FLOPs of a detector step, counted from the configuration's layer shapes.

Every convolution (and matmul) of the published architecture at an H x W
input: the backbone's, from the configuration's backbone file
(``work/backbones/<type>.py``: ``ops(cfg, h, w)`` -> its ops and its
output channels; ``bench.manifest.backbone_file``), the FPN (laterals on
the backbone's last three outputs, 3x3 outputs, P6 and P7 on its last),
the retina head's towers and predictors on each level, and, for R3Det,
each refine stage's FRM (1x5, 5x1 and 1x1 convs) and refine head. One
multiply-add is two FLOPs. Element-wise work (BN, ReLU, the sample,
decode, NMS, losses) is left out: it is a rounding error beside the convs
and would not change with the program's kernels either.

A training step adds the backward: a weight gradient for every trainable
op, and an input gradient for every op whose input carries one; the
backbone's ops say which they are.
"""
import math

from ..bench.manifest import HERE, backbone_file


def _out(n, stride):
    return math.ceil(n / stride)


def convs(cfg, h, w, base=HERE):
    """Every conv as (name, MACs, trainable, input_grad); the backbone
    file is looked up under ``base`` (the benchmark's directory)."""
    ops, chans = backbone_file(cfg, 'work', base).ops(cfg, h, w)
    out = list(ops)
    ch = cfg['feat_channels']
    sizes = [(_out(h, s), _out(w, s)) for s in cfg['strides']]
    for i, c in enumerate(chans[-3:]):
        lh, lw = sizes[i]
        out.append((f'neck.lateral_{i}', lh * lw * c * ch, True, True))
        out.append((f'neck.fpn_{i}', lh * lw * ch * ch * 9, True, True))
    out.append(('neck.extra_0',
                sizes[3][0] * sizes[3][1] * chans[-1] * ch * 9, True, True))
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


def forward_flops(cfg, h, w=None, base=HERE):
    """FLOPs of one image's forward pass."""
    return 2 * sum(m for _, m, _, _ in convs(cfg, h, w or h, base))


def train_flops(cfg, h, w=None, base=HERE):
    """FLOPs of one image's forward and backward pass."""
    total = 0
    for _, m, train, grad_in in convs(cfg, h, w or h, base):
        total += m + (m if train else 0) + (m if grad_in else 0)
    return 2 * total
