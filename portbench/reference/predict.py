"""Decode and rotated NMS of the reference, in float32.

mmrotate's test path for both detectors: per level the ``nms_pre``
positions with the highest class score (sigmoid), decoded against the
anchors (rotated RetinaNet) or the last refine stage's rois (R3Det), then
multiclass greedy NMS over the ``nms_candidates`` best (position, class)
pairs above ``score_thr``: a pair suppresses every later pair of its own
class whose rotated IoU with it exceeds ``nms_iou_thr``. Ties in score go
in ascending index order (position-major, class-minor), as a stable sort
gives them.

The greedy pass is the textbook sequential one, in numpy on the host, on
the IoU matrix of the live candidates (``boxes.rotated_iou``).
"""
import numpy as np
import torch

from . import boxes as bx


def candidates(outputs, cfg, featmap_sizes, img_shape):
    """(boxes (B, N, 5), scores (B, N, C)) of the per-level top
    ``nms_pre`` positions."""
    t = cfg['test']
    c = cfg['num_classes']
    if outputs.get('sr'):
        cls_scores, bbox_preds = outputs['sr'][-1]
        rois = outputs['rois'][-1]
    else:
        cls_scores, bbox_preds = outputs['s0']
        rois = None
        anchors = bx.grid_anchors(cfg, featmap_sizes, cls_scores[0].device)
    b = cls_scores[0].shape[0]
    mb, ms = [], []
    for lvl, (cls, reg) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls.reshape(b, -1, c).float())
        reg = reg.reshape(b, -1, 5).float()
        anc = rois[lvl] if rois is not None else \
            anchors[lvl][None].expand(b, -1, -1)
        k = min(t['nms_pre'], scores.shape[1])
        if k < scores.shape[1]:
            top = torch.sort(scores.amax(-1), dim=1, descending=True,
                             stable=True).indices[:, :k]
            scores = scores.gather(1, top[..., None].expand(-1, -1, c))
            reg = reg.gather(1, top[..., None].expand(-1, -1, 5))
            anc = anc.gather(1, top[..., None].expand(-1, -1, 5))
        mb.append(bx.decode(anc, reg, cfg, max_shape=img_shape))
        ms.append(scores)
    return torch.cat(mb, 1), torch.cat(ms, 1)


def select(boxes, scores, cfg):
    """The budget's (position, class) pairs above ``score_thr``, score
    order: boxes (B, K, 5), scores (B, K), labels (B, K), live (B,)."""
    t = cfg['test']
    b, n, c = scores.shape
    k = min(t.get('nms_candidates') or 2 * t['nms_pre'], n * c)
    flat = scores.reshape(b, n * c)
    gated = torch.where(flat > t['score_thr'], flat,
                        torch.full_like(flat, -1e30))
    top, idx = torch.sort(gated, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    fb = boxes[:, :, None, :].expand(b, n, c, 5).reshape(b, n * c, 5)
    return (fb.gather(1, idx[..., None].expand(-1, -1, 5)), top, idx % c,
            (top > -5e29).sum(1))


def greedy(iou, labels, thr):
    """Indices kept by sequential greedy NMS of score-sorted candidates."""
    n = len(labels)
    removed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if removed[i]:
            continue
        keep.append(i)
        removed[i + 1:] |= (iou[i, i + 1:] > thr) & \
            (labels[i + 1:] == labels[i])
    return np.asarray(keep, np.int64)


def nms(cand_boxes, cand_scores, cand_labels, live, cfg, iou_dtype=None):
    """Per image ``(boxes (n, 5), scores (n,), labels (n,))`` numpy arrays
    of the kept detections, score order, at most ``max_per_img``.
    ``iou_dtype`` computes the IoU from boxes rounded to that dtype (the
    lower-precision control)."""
    t = cfg['test']
    out = []
    for i in range(cand_boxes.shape[0]):
        v = int(live[i])
        bxs = cand_boxes[i, :v]
        if iou_dtype is not None:
            bxs = bxs.to(iou_dtype).float()
        iou = bx.rotated_iou(bxs, bxs).cpu().numpy() if v else \
            np.zeros((0, 0), np.float32)
        labels = cand_labels[i, :v].cpu().numpy()
        keep = greedy(iou, labels, t['nms_iou_thr'])[:t['max_per_img']]
        out.append((cand_boxes[i, :v].cpu().numpy()[keep],
                    cand_scores[i, :v].cpu().numpy()[keep], labels[keep]))
    return out


def predict(outputs, cfg, featmap_sizes, img_shape, iou_dtype=None):
    boxes, scores = candidates(outputs, cfg, featmap_sizes, img_shape)
    if iou_dtype is not None:
        scores = scores.to(iou_dtype).float()
    sel = select(boxes, scores, cfg)
    return nms(*sel, cfg, iou_dtype=iou_dtype), sel
