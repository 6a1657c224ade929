"""Config-facing rotated IoU calculators.

Port of ``r3det_tpu/core/iou_calculators.py`` (the reference's three
registry classes, rotate_iou2d_calculator.py). All three share
:func:`..ops.rotated_iou.rbbox_overlaps` (K1 for the pairwise form on CUDA
tensors) and differ in two policies: v2 and v3 take the detectron2/mmcv
angle convention (``negate_angle``), and v3 zeroes the overlaps of boxes
with min(w, h) below 1e-3.
"""
from ..ops.rotated_iou import rbbox_overlaps


class RBboxOverlaps2D_v1:
    """v1 (rbbox_geo backend): no negation, no small-box rule."""

    small_box_thr = None
    negate_angle = False

    def __call__(self, bboxes1, bboxes2, mode='iou', is_aligned=False):
        return rbbox_overlaps(bboxes1, bboxes2, mode=mode,
                              is_aligned=is_aligned,
                              small_box_thr=self.small_box_thr,
                              negate_angle=self.negate_angle)

    def __repr__(self):
        return self.__class__.__name__ + '()'


class RBboxOverlaps2D_v2(RBboxOverlaps2D_v1):
    """v2 (mmcv.ops.box_iou_rotated backend): the negated angle."""

    negate_angle = True


class RBboxOverlaps2D_v3(RBboxOverlaps2D_v1):
    """v3 (detectron2-derived backend): the negated angle and small-box
    zeroing."""

    small_box_thr = 1e-3
    negate_angle = True


def rbbox_overlaps_v1(bboxes1, bboxes2, mode='iou', is_aligned=False):
    return RBboxOverlaps2D_v1()(bboxes1, bboxes2, mode, is_aligned)


def rbbox_overlaps_v2(bboxes1, bboxes2, mode='iou', is_aligned=False):
    return RBboxOverlaps2D_v2()(bboxes1, bboxes2, mode, is_aligned)


def rbbox_overlaps_v3(bboxes1, bboxes2, mode='iou', is_aligned=False):
    return RBboxOverlaps2D_v3()(bboxes1, bboxes2, mode, is_aligned)
