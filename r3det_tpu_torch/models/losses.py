"""Detection losses: FocalLoss, CrossEntropyLoss (sigmoid), SmoothL1Loss
and L1Loss as the reference configs use them.

Port of ``r3det_tpu/models/losses.py``. Every loss follows mmdet's
weighted-reduce contract: elementwise loss times weight, summed, divided by
``max(avg_factor, 1)``. Labels equal to ``num_classes`` are background (an
all-zero one-hot row). The BCE term is the stable form
``max(z, 0) - z * t + log1p(exp(-|z|))``.
"""
import torch
import torch.nn.functional as F


def _one_hot(labels, num_classes, dtype):
    """(N,) labels in [0, C] -> (N, C); label C gives a zero row."""
    oh = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    return oh.to(dtype)


def _bce(logits, one_hot):
    return logits.clamp_min(0) - logits * one_hot + \
        torch.log1p(torch.exp(-logits.abs()))


def _reduce(loss, weights, avg_factor):
    return (loss * weights).sum() / torch.clamp_min(
        torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device),
        1.0)


def sigmoid_focal_loss(logits, labels, weights, num_classes, avg_factor,
                       gamma=2.0, alpha=0.25):
    """Sigmoid focal loss (RetinaNet): logits (N, C), labels (N,) in
    [0, C], per-anchor weights (N,)."""
    one_hot = _one_hot(labels, num_classes, logits.dtype)
    p = torch.sigmoid(logits)
    pt = p * one_hot + (1 - p) * (1 - one_hot)
    focal_weight = (alpha * one_hot + (1 - alpha) * (1 - one_hot)) * \
        (1 - pt) ** gamma
    loss = (_bce(logits, one_hot) * focal_weight).sum(-1)
    return _reduce(loss, weights, avg_factor)


def sigmoid_bce_loss(logits, labels, weights, num_classes, avg_factor):
    """Sigmoid cross entropy (mmdet CrossEntropyLoss(use_sigmoid=True)),
    per-anchor weights broadcast over the classes."""
    one_hot = _one_hot(labels, num_classes, logits.dtype)
    return _reduce(_bce(logits, one_hot).sum(-1), weights, avg_factor)


def _box_weights(weights, loss):
    return weights[..., None] if weights.dim() == loss.dim() - 1 else weights


def smooth_l1_loss(pred, target, weights, avg_factor, beta=1.0 / 9.0):
    """Smooth L1, per-anchor weights broadcast over the box dims."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, _box_weights(weights, loss), avg_factor)


def l1_loss(pred, target, weights, avg_factor):
    loss = (pred - target).abs()
    return _reduce(loss, _box_weights(weights, loss), avg_factor)
