"""MaxIoU assignment over padded ground truth, batched.

Port of ``r3det_tpu/core/assigner.py`` (mmdet's MaxIoUAssigner semantics):
a leading batch dimension written out takes the place of JAX's ``vmap``.

Codes per anchor: -1 ignore, 0 negative, k > 0 gt index k - 1. Padded gt
rows (``gt_mask`` False) are masked out of the argmax and of the
low-quality match, so the result is mmdet's on the unpadded list. Two
rules are kept from the JAX package: the low-quality match also requires
the gt's best IoU to be above 0 (mmdet assigns every anchor tying a best
IoU of 0, which fires on padded and synthetic inputs), and on an anchor
claimed by several gts the highest gt index wins (mmdet's loop order).
"""
from typing import NamedTuple

import torch


class AssignResult(NamedTuple):
    assigned: torch.Tensor        # (..., A) int32: -1 / 0 / k = gt k-1
    max_overlaps: torch.Tensor    # (..., A) float32


def max_iou_assign(overlaps, gt_mask, pos_iou_thr, neg_iou_thr,
                   min_pos_iou=0.0, match_low_quality=True,
                   gt_max_assign_all=True) -> AssignResult:
    """Assign anchors to gts from a dense ``(..., G, A)`` overlap matrix and
    a ``(..., G)`` bool ``gt_mask``."""
    num_gt = overlaps.shape[-2]
    ov = torch.where(gt_mask[..., None], overlaps,
                     torch.full_like(overlaps, -1.0))
    max_overlaps, argmax_overlaps = ov.max(dim=-2)        # first max wins
    minus1 = torch.full_like(argmax_overlaps, -1, dtype=torch.int32)
    zero = torch.zeros_like(minus1)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           zero, minus1)
    # no valid gt: every anchor is a negative (mmdet's num_gt == 0 branch)
    assigned = torch.where(gt_mask.any(-1, keepdim=True), assigned, zero)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           argmax_overlaps.to(torch.int32) + 1, assigned)

    if match_low_quality:
        gt_max = ov.amax(dim=-1)                               # (..., G)
        eligible = gt_mask & (gt_max >= min_pos_iou) & (gt_max > 0)
        if gt_max_assign_all:
            claims = (ov == gt_max[..., None]) & eligible[..., None]
        else:
            best = ov.argmax(dim=-1)
            cols = torch.arange(ov.shape[-1], device=ov.device)
            claims = (cols == best[..., None]) & eligible[..., None]
        gt_ids = torch.arange(num_gt, dtype=torch.int32,
                              device=ov.device)[:, None]
        claimed_by = torch.where(claims, gt_ids, torch.full_like(
            gt_ids, -1)).amax(dim=-2)
        assigned = torch.where(claimed_by >= 0, claimed_by + 1, assigned)

    return AssignResult(assigned=assigned,
                        max_overlaps=max_overlaps.clamp_min(0.0))
