"""The comparisons that decide ``correct``.

Serving (``serve_numbers``), on the steps sampled from the window, each
stage of the program judged on the program's own input to it (forward
hooks keep them, ``serve.capture``), as ||p - r|| / ||r - mean(r)|| over
all levels:

- ``err.fpn``: the FPN's output against the reference's backbone and FPN
  on the same images and weights;
- ``err.frm0`` (R3Det): what the FRM adds to its input (its convs and
  K2's sample, without the residual input, which would drown them)
  against the reference's FRM on the program's FPN and rois;
- ``err.tower.<head>.<branch>``: the input of each head's final cls and
  reg convs (the towers' output) against the reference's towers on the
  program's input to the head (the FPN, or the FRM's output);
- ``err.final.<head>.<branch>``: each head's cls logits and box deltas
  against the reference's final conv on the program's tower output;
- ``err.head.<head>.<branch>``: the same outputs against the reference's
  whole head on the program's input to the head (logged);
- ``roi_dist`` and ``roi_gap`` (R3Det): each of the program's rois is
  matched to the anchor whose reference decode it lies nearest, in delta
  units (``roi_dist``, the largest such distance); ``roi_gap`` is the
  largest amount by which that anchor's reference class logit lies below
  the reference's best anchor at the position (the argmax of
  ``filter_bboxes``, judged by the reference);
- ``det_mismatch``: the reference's decode and greedy NMS run on the
  program's head outputs (and rois), against the program's detections:
  the share of detections in either set with no counterpart of the same
  label, box and score (each within 1e-5 relative) in the other.

Training (``train_numbers``), on the program's first three steps from
the seed against the reference's (see ``bench/train.py``):

- ``loss_gap``: the largest |L_p - L_r| / |L_r| of the steps' total losses;
- ``grad_gap``: the first gradient as the optimizer got it (the program's
  momentum after one step less the weight decay of the initial weights),
  by the worst leaf, | |g_p| - |g_r| | over max(|g_r|, the median leaf's
  |g_r|);
- ``change_gap``: the same of the parameters' change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a FrozenBN or frozen conv leaf gets none, and
  moves by the weight decay alone);
- ``roi_dist`` (R3Det): the program's first-stage rois of each step
  against the reference's base head at that step, as in serving.
"""
import contextlib
import statistics

import numpy as np
import torch

from ..reference import boxes as rbx
from ..reference import predict as rpred


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convs in float32 (cuDNN takes TF32 by default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rel_err(p, r):
    p = torch.cat([t.reshape(-1).float() for t in p])
    r = torch.cat([t.reshape(-1).float() for t in r])
    return float((p - r).norm() / (r - r.mean()).norm().clamp_min(1e-30))


def roi_numbers(prog_rois, ref_out, cfg):
    """The program's first-stage rois against the reference's base head:
    {roi_gap, roi_gap_mean, roi_flip, roi_dist, roi_dist_mean}."""
    cls0, reg0 = ref_out['s0']
    na = len(cfg['ratios']) * cfg['scales_per_octave']
    c = cfg['num_classes']
    sizes = [tuple(t.shape[1:3]) for t in cls0]
    anchors = rbx.grid_anchors(cfg, sizes, cls0[0].device)
    gaps, dists, flips = [], [], []
    for cls, reg, anc, roi in zip(cls0, reg0, anchors, prog_rois):
        b, h, w, _ = cls.shape
        score = cls.reshape(b, h * w, na, c).amax(-1)
        reg = reg.reshape(b, h * w, na, 5)
        anc = anc.reshape(1, h * w, na, 5).expand(b, -1, -1, -1)
        delta = rbx.encode(anc, roi[:, :, None, :].expand(-1, -1, na, -1),
                           cfg)
        d = (delta - reg).abs().amax(-1)                      # (B, HW, A)
        dmin, j = d.min(-1)
        picked = score.gather(2, j[..., None])[..., 0]
        gaps.append((score.amax(-1) - picked).reshape(-1))
        dists.append(dmin.reshape(-1))
        flips.append((j != score.argmax(-1)).reshape(-1))
    gaps, dists, flips = torch.cat(gaps), torch.cat(dists), torch.cat(flips)
    return {'roi_gap': float(gaps.max()), 'roi_gap_mean': float(gaps.mean()),
            'roi_flip': float(flips.float().mean()),
            'roi_dist': float(dists.max()),
            'roi_dist_mean': float(dists.mean())}


def match_counts(p, r, tol=1e-5):
    """Unmatched rows of p and of r: rows (box 5, score, label) that have
    no row of the same label with every value within ``tol`` relative."""
    if len(p) == 0 or len(r) == 0:
        return len(p), len(r)
    close = (np.abs(p[:, None, :6] - r[None, :, :6])
             <= tol * (np.abs(r[None, :, :6]) + 1)).all(-1)
    close &= p[:, None, 6] == r[None, :, 6]
    return int((~close.any(1)).sum()), int((~close.any(0)).sum())


def det_rows(boxes, scores, labels):
    return np.concatenate([boxes, scores[:, None], labels[:, None]],
                          1).astype(np.float64)


def det_mismatch(prog_dets, ref_kept):
    """Share of unmatched detections, over both sets."""
    unmatched = total = 0
    dets, labels, num = prog_dets
    for i, (rb, rs, rl) in enumerate(ref_kept):
        n = int(num[i])
        p = det_rows(dets[i, :n, :5].numpy(), dets[i, :n, 5].numpy(),
                     labels[i, :n].numpy())
        r = det_rows(rb, rs, rl)
        up, ur = match_counts(p, r)
        unmatched += up + ur
        total += len(p) + len(r)
    return unmatched / max(total, 1)


def quantized(module, kind, *args):
    """``module(*args)`` with it and its submodules computing in ``kind``
    (``reference.model.fake_quant``)."""
    mods = list(module.modules())
    for m in mods:
        m.quant = kind
    try:
        return module(*args)
    finally:
        for m in mods:
            m.quant = None


def serve_numbers(samples, ref, cfg, sizes, img_shape, control=False):
    """The serving numbers over ``samples`` [(images, what ``serve.capture``
    kept, program detections on the host)], and the live candidates an
    image. ``control`` puts the reference, one precision below, in the
    program's place where the program's int8 path leaves it in bf16 or
    float32: the FRM (its convs and K2's sample) and each head's final
    convs in fp8 (e4m3) on the program's inputs to them, decode and NMS in
    bfloat16 on its head outputs."""
    nums = {}

    def worst(name, value):
        nums[name] = max(nums.get(name, 0.0), value)

    def f32(ts):
        return [t.float() for t in ts]

    def nhwc(ts):
        return [t.permute(0, 2, 3, 1) for t in ts]

    live = []
    with no_tf32(), torch.no_grad():
        for images, cap, dets in samples:
            out = cap['out']
            feats = ref.neck(ref.backbone(images))
            worst('err.fpn', rel_err(cap['fpn'], feats))
            if cfg['num_refine_stages']:
                base = {'s0': ref.bbox_head(feats)}
                for k, v in roi_numbers(out['rois'][0], base, cfg).items():
                    worst(k, v)
                del base
            del feats
            stages = [('s0', ref.bbox_head, cap['fpn'], out['s0'])]
            for i in range(cfg['num_refine_stages']):
                inp = f32(cap['fpn'] if i == 0 else cap[f'frm{i - 1}'])
                module = getattr(ref, f'frm_{i}')
                r = module(inp, out['rois'][i])
                got = cap[f'frm{i}']
                if control:
                    got = quantized(module, 'fp8', inp, out['rois'][i])
                worst(f'err.frm{i}', rel_err(
                    [p.float() - x for p, x in zip(got, inp)],
                    [q - x for q, x in zip(r, inp)]))
                del r, got, inp
                stages.append((f'sr{i}', getattr(ref, f'refine_head_{i}'),
                               cap[f'frm{i}'], out['sr'][i]))
            for key, head, inp, outputs in stages:
                towers = list(zip(*[head.towers(x) for x in f32(inp)]))
                for branch, got, tower in zip(('cls', 'reg'), outputs,
                                              towers):
                    conv = getattr(head, f'retina_{branch}')
                    mine = cap[f'tower.{key}.{branch}']
                    worst(f'err.tower.{key}.{branch}', rel_err(mine, tower))
                    worst(f'err.head.{key}.{branch}', rel_err(
                        got, nhwc(conv(t) for t in tower)))
                    r = nhwc(conv(t) for t in f32(mine))
                    if control:
                        got = nhwc(quantized(conv, 'fp8', t)
                                   for t in f32(mine))
                    worst(f'err.final.{key}.{branch}', rel_err(got, r))
                del towers
            kept, sel = rpred.predict(out, cfg, sizes, img_shape)
            live += [int(v) for v in sel[3]]
            if control:
                low = rpred.predict(out, cfg, sizes, img_shape,
                                    torch.bfloat16)[0]
                dets = to_padded(low, cfg['test']['max_per_img'])
            worst('det_mismatch', det_mismatch(dets, kept))
    return nums, live


def to_padded(kept, max_out):
    """Per-image kept detections -> (dets, labels, num) as the program
    returns them, on the host."""
    b = len(kept)
    dets = torch.zeros(b, max_out, 6)
    labels = torch.full((b, max_out), -1, dtype=torch.long)
    num = torch.zeros(b, dtype=torch.long)
    for i, (bx_, sc, lb) in enumerate(kept):
        n = len(sc)
        dets[i, :n, :5] = torch.from_numpy(bx_)
        dets[i, :n, 5] = torch.from_numpy(sc)
        labels[i, :n] = torch.from_numpy(lb)
        num[i] = n
    return dets, labels, num


def leaf_gaps(prog, ref, keep=None):
    """Per leaf | |p| - |r| | / max(|r|, the median leaf's |r|), over the
    leaves ``keep`` allows."""
    pn = [float(t.float().norm()) for t in prog]
    rn = [float(t.float().norm()) for t in ref]
    idx = [i for i in range(len(rn)) if keep is None or keep[i]]
    med = statistics.median([rn[i] for i in idx])
    return {i: abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx}


def train_numbers(prog, ref, names):
    """``prog`` and ``ref``: {'losses': [floats], 'grad': [leaves],
    'change': [leaves]}; returns the numbers and the worst leaves."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog['losses'],
                                                ref['losses'])]
    grad = leaf_gaps(prog['grad'], ref['grad'])
    gn = [float(g.norm()) for g in ref['grad']]
    med = statistics.median(gn)
    keep = [v >= 1e-3 * med for v in gn]
    change = leaf_gaps(prog['change'], ref['change'], keep)
    gw = max(grad, key=grad.get)
    cw = max(change, key=change.get)
    nums = {'loss_gap': max(gaps), 'loss1_gap': gaps[0],
            'grad_gap': grad[gw],
            'grad_med': statistics.median(grad.values()),
            'change_gap': change[cw],
            'change_med': statistics.median(change.values())}
    if 'roi_dist' in ref:
        nums['roi_dist'] = ref['roi_dist']
    return (nums,
            {'grad_leaf': names[gw], 'change_leaf': names[cw],
             'leaves_compared': sum(keep)})
