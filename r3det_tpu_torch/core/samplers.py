"""Anchor samplers with static shapes, as masks.

Port of ``r3det_tpu/core/samplers.py``. ``pseudo_sample`` keeps every
assigned anchor (the focal-loss configurations); ``random_sample`` keeps at
most ``num * pos_fraction`` random positives and fills the budget with
random negatives (RRandomSampler, the BCE route).

``random_sample`` is split in two: it draws the two uniform score vectors
from a ``torch.Generator``, and :func:`random_sample_masks` is a
deterministic function of the draws. The JAX package draws with
``jax.random`` (another stream); fed JAX's own draws,
:func:`random_sample_masks` gives JAX's masks.
"""
from typing import NamedTuple

import torch


class SamplerCfg(NamedTuple):
    """RRandomSampler's config (num, pos_fraction, neg_pos_ub)."""
    num: int = 256
    pos_fraction: float = 0.5
    neg_pos_ub: float = -1.0


class SampleResult(NamedTuple):
    pos_mask: torch.Tensor     # (..., A) bool
    neg_mask: torch.Tensor     # (..., A) bool


def pseudo_sample(assigned) -> SampleResult:
    """PseudoSampler: all positives and all negatives kept."""
    return SampleResult(pos_mask=assigned > 0, neg_mask=assigned == 0)


def random_sample_masks(assigned, u_pos, u_neg, num=256, pos_fraction=0.5,
                        neg_pos_ub=-1.0) -> SampleResult:
    """RRandomSampler's masks from given uniform scores, over the last
    dimension (``assigned``, ``u_pos``, ``u_neg`` all ``(..., A)``).

    Positives: the ``k = int(num * pos_fraction)`` best-scored positives
    (every score at or above the k-th largest; all of them when there are
    at most k). Negatives: the ``num - min(kept positives, k)`` best-scored
    negatives by rank (a stable sort: ties by index), capped at
    ``neg_pos_ub * max(kept positives, 1)`` when ``neg_pos_ub > 0``."""
    pos = assigned > 0
    neg = assigned == 0
    k_pos = int(num * pos_fraction)
    ninf = torch.tensor(float('-inf'), device=u_pos.device)
    scores = torch.where(pos, u_pos, ninf)
    kth = torch.sort(scores, dim=-1).values[..., -k_pos:][..., :1]
    keep = pos & (scores >= kth)
    pos_keep = torch.where(pos.sum(-1, keepdim=True) <= k_pos, pos, keep)
    n_pos = pos_keep.sum(-1, keepdim=True)
    n_neg_budget = num - torch.clamp_max(n_pos, k_pos)
    if neg_pos_ub > 0:
        cap = (neg_pos_ub * torch.clamp_min(n_pos, 1)).to(torch.int32)
        n_neg_budget = torch.minimum(n_neg_budget, cap)
    scores = torch.where(neg, u_neg, ninf)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order).contiguous())
    return SampleResult(pos_mask=pos_keep,
                        neg_mask=neg & (rank < n_neg_budget))


def random_sample(generator, assigned, num=256, pos_fraction=0.5,
                  neg_pos_ub=-1.0, shard=(0, 1)) -> SampleResult:
    """RRandomSampler: two uniform [0, 1) f32 draws of ``assigned``'s
    shape from ``generator`` (positives', then negatives' scores), then
    :func:`random_sample_masks`.

    ``shard``, (rank, ranks): ``assigned`` holds this rank's images of a
    global batch of ``ranks`` equal local batches. Each draw then covers
    the global batch and the rank keeps its own rows, so every rank's
    masks are the single process's on the global batch."""
    rank, ranks = shard
    b = assigned.shape[0]
    shape = (b * ranks,) + tuple(assigned.shape[1:])
    u_pos, u_neg = (torch.rand(shape, generator=generator,
                               device=assigned.device)[rank * b:(rank + 1) * b]
                    for _ in range(2))
    return random_sample_masks(assigned, u_pos, u_neg, num, pos_fraction,
                               neg_pos_ub)
