"""Training targets for anchor heads, batched with static shapes.

Port of ``r3det_tpu/core/targets.py`` (the reference's RAnchorHead.
get_targets): a leading batch dimension written out replaces JAX's
``vmap`` over images. Ground truth arrives padded: ``(B, G, 5)`` boxes,
``(B, G)`` labels and a ``(B, G)`` bool mask.

Assignment IoU:
- ``assign_by_circumhbbox`` set (the base head): gts become their
  circumscribed boxes and anchors their axis-aligned extents (xyxy
  anchors, ``hbb_anchors``, as they are), and the overlap is the
  axis-aligned IoU;
- ``None`` (the refine stages): the rotated IoU of
  :func:`..ops.rotated_iou.rotated_iou`, ``(B, G, 5) x (B, A, 5)``, which
  launches K1 on CUDA tensors (``kernels`` off takes its plain form); xyxy
  anchors become oriented boxes by ``hbb2obb`` first. v2 and v3 use the
  negated angle convention, as the JAX package does.
"""
from typing import Any, NamedTuple, Optional

import torch

from . import rtransforms as rt
from .assigner import max_iou_assign
from .samplers import random_sample
from ..ops.rotated_iou import (negate_theta, rotated_iou,
                               rotated_iou_reference)


class TargetConfig(NamedTuple):
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    pos_weight: float = -1.0
    assign_by_circumhbbox: Optional[str] = 'v1'   # None -> rotated assign
    angle_version: str = 'v1'                      # coder version
    hbb_anchors: bool = False                      # anchors are xyxy (4)
    # RRandomSampler (core/samplers.py::SamplerCfg); None -> every
    # assigned anchor participates. Needs a generator when set.
    sampler: Any = None


class AnchorTargets(NamedTuple):
    labels: torch.Tensor          # (B, A) int32, num_classes = background
    label_weights: torch.Tensor   # (B, A) float32
    bbox_targets: torch.Tensor    # (B, A, 5) float32 encoded deltas
    bbox_weights: torch.Tensor    # (B, A) float32
    num_pos: torch.Tensor         # (B,) int32 (after sampling)
    assigned_gt: torch.Tensor     # (B, A) int32 (-1 ignore / 0 neg / k)
    num_neg: torch.Tensor         # (B,) int32 (after sampling)


def _hbb_iou(boxes1_xyxy, boxes2_xyxy):
    """Axis-aligned IoU ``(..., G, 4) x (..., A, 4) -> (..., G, A)``."""
    x11, y11, x12, y12 = [boxes1_xyxy[..., :, None, i] for i in range(4)]
    x21, y21, x22, y22 = [boxes2_xyxy[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp_min(0.0)
    ih = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp_min(0.0)
    inter = iw * ih
    a1 = (x12 - x11).clamp_min(0.0) * (y12 - y11).clamp_min(0.0)
    a2 = (x22 - x21).clamp_min(0.0) * (y22 - y21).clamp_min(0.0)
    return inter / (a1 + a2 - inter).clamp_min(1e-10)


def _overlaps(anchors, gt_bboxes, cfg, kernels):
    """(B, G, A) assignment overlaps; ``anchors`` (B or 1, A, 5), or
    (1, A, 4) xyxy under ``cfg.hbb_anchors``."""
    version = cfg.angle_version
    if cfg.assign_by_circumhbbox is not None:
        hv = cfg.assign_by_circumhbbox
        gt_assign = rt.obb2xyxy(rt.obb2hbb(gt_bboxes, hv), hv)
        anc = anchors if cfg.hbb_anchors else rt.obb2xyxy(anchors, version)
        return _hbb_iou(gt_assign, anc)
    anc5 = rt.hbb2obb(anchors, version) if cfg.hbb_anchors else anchors
    anc5 = anc5.expand(gt_bboxes.shape[0], -1, -1)
    gts = gt_bboxes
    if version != 'v1':
        gts, anc5 = negate_theta(gts), negate_theta(anc5)
    iou = rotated_iou if kernels else rotated_iou_reference
    return iou(gts.float().contiguous(), anc5.float().contiguous())


def anchor_targets(anchors, gt_bboxes, gt_labels, gt_mask, encode_fn,
                   num_classes, cfg: TargetConfig, per_image_anchors=False,
                   generator=None, kernels=True,
                   shard=(0, 1)) -> AnchorTargets:
    """Batched targets.

    anchors: (A, 5) anchors shared by the batch ((A, 4) xyxy under
    ``cfg.hbb_anchors``), or (B, A, 5) per-image rois when
    ``per_image_anchors`` (refine stages). gt_bboxes (B, G, 5),
    gt_labels (B, G) int, gt_mask (B, G) bool. ``encode_fn``: a coder's
    encode. ``generator``: the ``torch.Generator`` of the sampler's draws,
    needed when ``cfg.sampler`` is set; ``shard``, (rank, ranks), says
    which rows of the global batch's draws are this batch's
    (``samplers.random_sample``). ``kernels`` off takes the plain rotated
    IoU on a card.
    """
    if not per_image_anchors:
        anchors = anchors[None]
    overlaps = _overlaps(anchors, gt_bboxes, cfg, kernels)
    res = max_iou_assign(overlaps, gt_mask, pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou)
    if cfg.sampler is not None:
        if generator is None:
            raise ValueError('cfg.sampler is set: anchor_targets needs a '
                             'generator')
        s = cfg.sampler
        pos, neg = random_sample(generator, res.assigned, num=s.num,
                                 pos_fraction=s.pos_fraction,
                                 neg_pos_ub=s.neg_pos_ub, shard=shard)
    else:
        pos = res.assigned > 0
        neg = res.assigned == 0
    gt_idx = (res.assigned - 1).clamp_min(0).long()         # (B, A)
    matched_gt = gt_bboxes.gather(
        1, gt_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
    bbox_targets = encode_fn(anchors.expand(matched_gt.shape[0], -1, -1),
                             matched_gt)
    bbox_targets = torch.where(pos[..., None], bbox_targets,
                               torch.zeros_like(bbox_targets))
    labels = torch.where(pos, gt_labels.gather(1, gt_idx).to(torch.int32),
                         torch.full_like(gt_idx, num_classes,
                                         dtype=torch.int32))
    pw = 1.0 if cfg.pos_weight <= 0 else cfg.pos_weight
    zero = torch.zeros_like(overlaps[:, 0])
    label_weights = torch.where(pos, zero + pw, zero) + \
        torch.where(neg, zero + 1.0, zero)
    return AnchorTargets(
        labels=labels, label_weights=label_weights,
        bbox_targets=bbox_targets, bbox_weights=pos.float(),
        num_pos=pos.sum(-1).to(torch.int32),
        assigned_gt=res.assigned - 1,
        num_neg=neg.sum(-1).to(torch.int32))


def num_total_samples(num_pos):
    """The reference's normalizer: the sum over images of max(n, 1)."""
    return num_pos.clamp_min(1).sum().float()
