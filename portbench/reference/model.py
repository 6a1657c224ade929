"""The plain float32 forward of R3Det and rotated RetinaNet.

The benchmark's reference: plain ``torch`` operations in float32, with no
kernel, cache or batching trick, written from the configuration's sizes.
It imports nothing of the program under test. The modules carry the
program's parameter and buffer names, so the one state dict that the
benchmark draws from the seed loads into both.

It follows mmrotate's R3Det and RotatedRetinaNet (the backbone, FPN P3-P7
on the backbone's last three outputs with the extra levels on its last,
RetinaHead towers, the FRM of R3Det), with these departures, each the
program's definition:

- the stem is the folded 4x4/s1 conv on the 2x2 space-to-depth image
  (the program's ``conv1.kernel``, (4, 4, 12, 64) HWIO, padded 2 before
  and 1 after), which is a 7x7/s2 conv when the folded kernel's first row
  and column are zero; seeded weights fill them, so it stays folded;
- FrozenBN is ``x * (scale / sqrt(var + eps)) + (bias - mean * ...)``;
- the FRM samples at each position's best box centre with the
  reference implementation's transposed coordinates (row <- cx / stride,
  col <- cy / stride), bilinear with f32 weights, then ``x + (feat +
  sample)``;
- images are NHWC; head outputs (B, H, W, A*C) and (B, H, W, A*5).

The backbone is the configuration's (``bench.manifest.backbone_file``:
``backbones/<type>.py``, ``resnet`` when the configuration names none):
its ``build(cfg)`` returns a module whose forward takes the NHWC images
to a list of NCHW float32 feature maps, with an ``out_channels`` tuple.
``resnet`` is ResNet with frozen BN and the folded stem above.

``forward(images, rois=None)``: with ``rois`` (the per-level rois of each
refine stage) the refine stages sample at those rois instead of at the
reference's own, so that the refine head can be checked on the program's
rois (``filter_bboxes`` is an argmax, and near-ties flip between
precisions).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..bench.manifest import HERE, backbone_file
from . import boxes as bx

FP8_MAX = 448.0                    # float8_e4m3fn's largest finite value


def fake_quant(x, kind, dim=None):
    """``x`` rounded to ``kind`` ('int8': symmetric, 127 steps; 'fp8':
    float8 e4m3) after scaling its absmax (per tensor, or per slice along
    ``dim``) to the format's largest value, with a straight-through
    gradient: the precision of the training control."""
    if dim is None:
        amax = x.detach().abs().amax()
    else:
        amax = x.detach().abs().amax(dim=[d for d in range(x.dim())
                                          if d != dim], keepdim=True)
    if kind == 'int8':
        s = amax.clamp_min(1e-30) / 127.0
        q = (x / s).round().clamp(-127, 127) * s
    else:
        s = amax.clamp_min(1e-30) / FP8_MAX
        q = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Conv(nn.Conv2d):
    """A float32 conv; with ``quant`` set ('int8' or 'fp8') its input and
    output (per tensor) and its weight (per output channel) are rounded to
    that precision."""
    quant = None

    def forward(self, x):
        if self.quant:
            y = self._conv_forward(fake_quant(x, self.quant),
                                   fake_quant(self.weight, self.quant, 0),
                                   self.bias)
            return fake_quant(y, self.quant)
        return super().forward(x)


def conv(cin, cout, k, stride=1, padding=0, bias=True):
    return Conv(cin, cout, k, stride=stride, padding=padding, bias=bias)


class FrozenBN(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('mean', torch.zeros(c))
        self.register_buffer('var', torch.ones(c))

    def forward(self, x):
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        off = self.bias - self.mean * inv
        return x * inv.view(1, -1, 1, 1) + off.view(1, -1, 1, 1)


def __getattr__(name):
    """ResNet's names, from ``backbones/resnet.py``."""
    if name in ('ResNet', 'Bottleneck', 'STAGE_BLOCKS', 'WIDTHS'):
        return getattr(backbone_file({'backbone': 'resnet'}, 'reference'),
                       name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


class FPN(nn.Module):
    """Laterals on the last three of the backbone's outputs, P6 and P7 on
    its last (mmdet's ``add_extra_convs='on_input'``)."""

    def __init__(self, in_channels, out=256):
        super().__init__()
        used = in_channels[-3:]
        self.n = len(used)
        for i, c in enumerate(used):
            self.add_module(f'lateral_{i}', conv(c, out, 1))
            self.add_module(f'fpn_{i}', conv(out, out, 3, padding=1))
        self.extra_0 = conv(in_channels[-1], out, 3, 2, 1)
        self.extra_1 = conv(out, out, 3, 2, 1)

    def forward(self, feats):
        used = feats[-3:]
        lat = [getattr(self, f'lateral_{i}')(used[i]) for i in range(self.n)]
        for i in range(self.n - 1, 0, -1):
            th, tw = lat[i - 1].shape[2:]
            up = F.interpolate(lat[i], scale_factor=2.0, mode='nearest')
            lat[i - 1] = lat[i - 1] + up[:, :, :th, :tw]
        outs = [getattr(self, f'fpn_{i}')(lat[i]) for i in range(self.n)]
        p6 = self.extra_0(feats[-1])
        outs += [p6, self.extra_1(F.relu(p6))]
        return outs


class RetinaHead(nn.Module):
    def __init__(self, num_classes, channels, stacked_convs, num_anchors):
        super().__init__()
        self.stacked_convs = stacked_convs
        for branch in ('cls', 'reg'):
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv_{i}',
                                conv(channels, channels, 3, padding=1))
        self.retina_cls = conv(channels, num_anchors * num_classes, 3,
                               padding=1)
        self.retina_reg = conv(channels, num_anchors * 5, 3, padding=1)

    def towers(self, x):
        """Both towers on one level: the inputs (cls, reg) of the final
        convs."""
        c = r = x
        for i in range(self.stacked_convs):
            c = F.relu(getattr(self, f'cls_conv_{i}')(c))
            r = F.relu(getattr(self, f'reg_conv_{i}')(r))
        return c, r

    def forward(self, feats):
        cls, reg = [], []
        for x in feats:
            c, r = self.towers(x)
            cls.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg.append(self.retina_reg(r).permute(0, 2, 3, 1))
        return cls, reg


def bilinear_sample(feat, py, px):
    """feat (B, H, W, C) sampled at fractional (row, col) points (B, N):
    0 outside (-1, H) x (-1, W), coordinates clamped inside."""
    b, h, w, c = feat.shape
    inside = (py > -1.0) & (py < h) & (px > -1.0) & (px < w)
    py = py.clamp(0.0, h - 1.0)
    px = px.clamp(0.0, w - 1.0)
    y0, x0 = py.floor().long(), px.floor().long()
    y1, x1 = (y0 + 1).clamp_max(h - 1), (x0 + 1).clamp_max(w - 1)
    ly, lx = py - y0, px - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(b, h * w, c)

    def at(idx):
        return flat.gather(1, idx[..., None].expand(-1, -1, c))

    val = (hy * hx)[..., None] * at(y0 * w + x0) + \
        (hy * lx)[..., None] * at(y0 * w + x1) + \
        (ly * hx)[..., None] * at(y1 * w + x0) + \
        (ly * lx)[..., None] * at(y1 * w + x1)
    return torch.where(inside[..., None], val, torch.zeros_like(val))


class FRM(nn.Module):
    """The FRM; with ``quant`` set its convs (each ``Conv``'s own
    ``quant``) and the features it samples are rounded to that
    precision."""

    def __init__(self, channels, strides):
        super().__init__()
        self.strides = tuple(strides)
        self.conv_5_1 = conv(channels, channels, (5, 1), padding=(2, 0))
        self.conv_1_5 = conv(channels, channels, (1, 5), padding=(0, 2))
        self.conv_1_1 = conv(channels, channels, 1)

    quant = None

    def forward(self, feats, rois):
        out = []
        for x, r, s in zip(feats, rois, self.strides):
            feat = self.conv_5_1(self.conv_1_5(x)) + self.conv_1_1(x)
            fn = feat.permute(0, 2, 3, 1)
            if self.quant:                    # the sample's input rounded
                fn = fake_quant(fn, self.quant)
            b, h, w, c = fn.shape
            # transposed coordinates, as the reference's CUDA op reads them
            val = bilinear_sample(fn, r[..., 0] / s, r[..., 1] / s)
            val = val.reshape(b, h, w, c).permute(0, 3, 1, 2)
            out.append(x + (feat + val))
        return out


class Detector(nn.Module):
    """R3Det (``num_refine_stages`` > 0) or rotated RetinaNet, from the
    benchmark's configuration dict; the backbone file is looked up under
    ``base`` (the benchmark's directory). ``seed_rule`` is the file's
    rule for ``common.seeded_state``, or None."""

    def __init__(self, cfg, base=HERE):
        super().__init__()
        self.cfg = cfg
        ch = cfg['feat_channels']
        na = len(cfg['ratios']) * cfg['scales_per_octave']
        parts = backbone_file(cfg, 'reference', base)
        self.seed_rule = getattr(parts, 'seed_rule', None)
        self.backbone = parts.build(cfg)
        self.neck = FPN(self.backbone.out_channels, out=ch)
        self.bbox_head = RetinaHead(cfg['num_classes'], ch,
                                    cfg['stacked_convs'], na)
        for i in range(cfg['num_refine_stages']):
            self.add_module(f'frm_{i}', FRM(ch, cfg['strides']))
            self.add_module(f'refine_head_{i}', RetinaHead(
                cfg['num_classes'], ch,
                cfg.get('refine_stacked_convs') or cfg['stacked_convs'], 1))

    def forward(self, images, rois=None):
        return self.heads(self.neck(self.backbone(images)), rois,
                          images.device)

    def heads(self, feats, rois=None, device=None):
        """The base head and the refine stages on FPN features ``feats``."""
        cfg = self.cfg
        cls0, reg0 = self.bbox_head(feats)
        out = {'s0': (cls0, reg0), 'sr': [], 'rois': []}
        if not cfg['num_refine_stages']:
            return out
        sizes = [tuple(c.shape[1:3]) for c in cls0]
        anchors = bx.grid_anchors(cfg, sizes, device)
        cur = filter_bboxes(cls0, reg0, anchors, cfg)
        for i in range(cfg['num_refine_stages']):
            if rois is not None:
                cur = rois[i]
            feats = getattr(self, f'frm_{i}')(feats, cur)
            cls, reg = getattr(self, f'refine_head_{i}')(feats)
            out['sr'].append((cls, reg))
            out['rois'].append(cur)
            if i + 1 < cfg['num_refine_stages']:
                cur = [bx.decode(r0, rg.reshape(r0.shape), cfg).detach()
                       for r0, rg in zip(cur, reg)]
        return out


def filter_bboxes(cls_scores, bbox_preds, anchors, cfg):
    """Per level and position, the anchor with the highest class logit,
    decoded: (B, H*W, 5), no gradient."""
    na = len(cfg['ratios']) * cfg['scales_per_octave']
    c = cfg['num_classes']
    rois = []
    for cls, reg, anc in zip(cls_scores, bbox_preds, anchors):
        b, h, w, _ = cls.shape
        best = cls.reshape(b, h * w, na, c).amax(-1).argmax(-1)
        idx = best[:, :, None, None].expand(-1, -1, 1, 5)
        breg = reg.reshape(b, h * w, na, 5).gather(2, idx)[:, :, 0]
        banc = anc.reshape(1, h * w, na, 5).expand(b, -1, -1, -1) \
            .gather(2, idx)[:, :, 0]
        rois.append(bx.decode(banc, breg, cfg).detach())
    return rois


def focal_bias(prior=0.01):
    return -math.log((1 - prior) / prior)
