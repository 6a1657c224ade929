"""Targets, losses and the SGD update of the reference, in float32.

mmrotate's RotatedRetinaHead / R3Det training as the configurations ship
it: MaxIoU assignment (every anchor at or above ``pos_iou_thr`` takes its
best gt, below ``neg_iou_thr`` is negative, and each gt also claims the
anchors that tie its own best IoU, when that IoU is above 0; on an anchor
claimed by several gts the highest gt index wins), no sampler (focal
loss), the v1 delta targets, sigmoid focal loss (gamma 2, alpha 0.25) and
smooth L1 (or L1) summed and divided by the sum over images of max(number
of positives, 1). The base head of R3Det assigns by the axis-aligned IoU
of the gts' circumscribed boxes with the anchors' extents; the refine
stages, and rotated RetinaNet's base head, by the rotated IoU with each
image's rois (anchors).

The update is optax's chain, as the program ships it: the gradients
clipped to a global L2 norm of 35, weight decay 1e-4 added, SGD with
momentum 0.9 at the 1x schedule's warmup learning rate. Every parameter
is updated and decayed, the frozen ones (whose gradient is zero)
included.
"""
import torch
import torch.nn.functional as F

from . import boxes as bx


def assign(overlaps, gt_mask, pos_thr, neg_thr, min_pos=0.0):
    """(B, G, A) overlaps -> (B, A) codes: -1 ignore, 0 negative, k gt k-1."""
    num_gt = overlaps.shape[-2]
    ov = torch.where(gt_mask[..., None], overlaps,
                     torch.full_like(overlaps, -1.0))
    best, arg = ov.max(dim=-2)
    out = torch.where((best >= 0) & (best < neg_thr), 0, -1)
    out = torch.where(gt_mask.any(-1, keepdim=True), out, 0)
    out = torch.where(best >= pos_thr, arg + 1, out)
    gt_best = ov.amax(-1)
    ok = gt_mask & (gt_best >= min_pos) & (gt_best > 0)
    claims = (ov == gt_best[..., None]) & ok[..., None]
    ids = torch.arange(num_gt, device=ov.device)[:, None]
    claimed = torch.where(claims, ids, -1).amax(-2)
    return torch.where(claimed >= 0, claimed + 1, out)


def targets(anchors, gt_boxes, gt_labels, gt_mask, cfg, stage,
            per_image):
    """Labels (B, A) (C for background), label weights, box targets
    (B, A, 5), box weights (B, A) and the positives' count (B,)."""
    anchors = anchors if per_image else anchors[None]
    if stage['assign_by_circumhbbox'] is not None:
        ov = bx.hbb_iou(bx.circum_xyxy_v1(gt_boxes), bx.obb2xyxy_v1(anchors))
    else:
        b = gt_boxes.shape[0]
        ov = bx.rotated_iou(gt_boxes.float(), anchors.expand(b, -1, -1))
    codes = assign(ov, gt_mask, stage['pos_iou_thr'], stage['neg_iou_thr'],
                   stage['min_pos_iou'])
    pos, neg = codes > 0, codes == 0
    gi = (codes - 1).clamp_min(0)
    matched = gt_boxes.gather(1, gi[..., None].expand(-1, -1, 5))
    tgt = bx.encode(anchors.expand(matched.shape[0], -1, -1), matched, cfg)
    tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))
    labels = torch.where(pos, gt_labels.gather(1, gi).long(),
                         cfg['num_classes'])
    return labels, (pos | neg).float(), tgt, pos.float(), pos.sum(-1)


def focal_loss(logits, labels, weights, c, avg, gamma, alpha):
    onehot = F.one_hot(labels, c + 1)[..., :c].float()
    p = torch.sigmoid(logits)
    pt = p * onehot + (1 - p) * (1 - onehot)
    fw = (alpha * onehot + (1 - alpha) * (1 - onehot)) * (1 - pt) ** gamma
    bce = logits.clamp_min(0) - logits * onehot + \
        torch.log1p(torch.exp(-logits.abs()))
    return ((bce * fw).sum(-1) * weights).sum() / avg


def box_loss(pred, target, weights, avg, kind, beta):
    d = (pred - target).abs()
    if kind == 'smooth_l1':
        d = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return (d * weights[..., None]).sum() / avg


def head_loss(cls, reg, anchors, batch, cfg, stage, per_image):
    c = cfg['num_classes']
    b = cls[0].shape[0]
    logits = torch.cat([t.reshape(b, -1, c) for t in cls], 1).float()
    deltas = torch.cat([t.reshape(b, -1, 5) for t in reg], 1).float()
    labels, lw, tgt, bw, npos = targets(
        anchors, batch['gt_bboxes'], batch['gt_labels'], batch['gt_mask'],
        cfg, stage, per_image)
    avg = npos.clamp_min(1).sum().float()
    lc = focal_loss(logits.reshape(-1, c), labels.reshape(-1),
                    lw.reshape(-1), c, avg, cfg['focal_gamma'],
                    cfg['focal_alpha'])
    lb = box_loss(deltas.reshape(-1, 5), tgt.reshape(-1, 5), bw.reshape(-1),
                  avg, cfg['loss_bbox_type'], cfg['smooth_l1_beta'])
    return lc, lb


def detector_loss(model, batch, cfg, rois=None, keep=None):
    """The losses of ``model`` (the reference detector) on ``batch``:
    ``{'s0.loss_cls', 's0.loss_bbox', 'sr0.loss_cls', ..., 'total'}``,
    and the forward's outputs. ``rois``: the refine stages' rois to follow
    (``Detector.forward``); ``keep``: take the loss over the batch's first
    ``keep`` images only (a planted fault)."""
    out = model(batch['image'], rois=rois)
    if keep is not None:
        batch = {k: v[:keep] for k, v in batch.items()}
        out = {'s0': tuple([t[:keep] for t in ts] for ts in out['s0']),
               'sr': [tuple([t[:keep] for t in ts] for ts in sr)
                      for sr in out['sr']],
               'rois': [[t[:keep] for t in r] for r in out['rois']]}
    sizes = [tuple(t.shape[1:3]) for t in out['s0'][0]]
    anchors = torch.cat(bx.grid_anchors(cfg, sizes, batch['image'].device))
    losses = {}
    lc, lb = head_loss(*out['s0'], anchors, batch, cfg, cfg['s0_train'],
                       False)
    losses['s0.loss_cls'], losses['s0.loss_bbox'] = lc, lb
    for i, (cls, reg) in enumerate(out['sr']):
        rois = torch.cat(out['rois'][i], 1)
        w = cfg['stage_loss_weights'][i]
        lc, lb = head_loss(cls, reg, rois, batch, cfg, cfg['sr_train'][i],
                           True)
        losses[f'sr{i}.loss_cls'], losses[f'sr{i}.loss_bbox'] = lc * w, lb * w
    losses['total'] = sum(losses.values())
    return losses, out


def learning_rate(step, opt):
    """The 1x schedule's learning rate at update ``step`` (warmup only:
    the benchmark's steps lie far before the first decay)."""
    if step >= opt['warmup_iters']:
        raise ValueError('the reference covers the warmup steps only')
    r = opt['warmup_ratio']
    return opt['base_lr'] * (r + (1 - r) * step / opt['warmup_iters'])


class SGD:
    """optax's clip(35) -> add_decayed_weights(1e-4) -> sgd(momentum 0.9)."""

    def __init__(self, params, opt):
        self.params = list(params)
        self.opt = opt
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        o = self.opt
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if norm >= o['clip_norm']:
            grads = [g / norm * o['clip_norm'] for g in grads]
        lr = learning_rate(self.count, o)
        for p, g, t in zip(self.params, grads, self.trace):
            t.mul_(o['momentum']).add_(g + o['weight_decay'] * p)
            p.add_(t * -lr)
        self.count += 1
        return grads


def train_steps(model, batches, cfg, opt, rois=None, keep=None):
    """Run the reference's steps on ``batches``: returns the total loss of
    each step, the clipped gradients of the first step, in parameter
    order, each step's refine-stage rois and each step's base head
    outputs (cls, reg). ``rois`` (one list a step) are followed; ``keep``
    plants the fault of ``detector_loss``. ``model`` is updated in
    place."""
    sgd = SGD(model.parameters(), opt)
    losses, first, used, heads = [], None, [], []
    for i, batch in enumerate(batches):
        model.zero_grad(set_to_none=True)
        loss, out = detector_loss(model, batch, cfg,
                                  None if rois is None else rois[i], keep)
        used.append([[t.detach() for t in r] for r in out['rois']])
        heads.append(tuple([t.detach() for t in ts] for ts in out['s0']))
        loss['total'].backward()
        g = sgd.step([p.grad for p in model.parameters()])
        if first is None:
            first = [x.detach().clone() for x in g]
        losses.append(float(loss['total'].detach()))
    model.zero_grad(set_to_none=True)
    return losses, first, used, heads
