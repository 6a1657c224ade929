"""Batched multiclass rotated NMS (v1/v2/v3/mmcv), static output shapes.

Port of ``r3det_tpu/ops/nms.py`` (``_select_candidates``, ``_nms_core``,
``_greedy_keep_blocked``, ``_gather_dets``, ``_sweep_dets``,
``multiclass_nms_rotated_batched``). Every version is one label-gated
greedy pass (cross-class IoU is zero); the version picks only the angle
convention (v3/mmcv negate theta) and the v3 tiny-box skip.

Differences from the JAX form, none of which changes a keep set:

- everything is batched over images explicitly (no vmap);
- ties in score order follow ascending index, as JAX's ``lax.top_k`` and
  stable ``argsort`` do: every sort here is ``stable=True``;
- the adaptive budget's ``lax.cond`` is one host ``if`` on the live count,
  one device-to-host sync per batch;
- the greedy sweep checks convergence once per round for all images;
- the pairwise IoU is :func:`~r3det_tpu_torch.ops.rotated_iou.rotated_iou`
  (the K1 kernel on CUDA tensors).
"""
import torch

from .rotated_iou import negate_theta, rotated_iou, rotated_iou_reference

NEG_INF = -1e30
BLOCK_S = 256
# the JAX package streams (K, block) IoU slabs above this budget; the
# port has no streamed sweep yet
STREAM_THRESHOLD = 4096


def greedy_keep_blocked(iou, valid, iou_thr, block=BLOCK_S):
    """Exact greedy suppression over score-sorted boxes, batched.

    iou (B, K, K), valid (B, K) bool -> keep (B, K) bool. Blocks of
    ``block`` boxes go in score order: suppression from earlier (final)
    blocks in one masked reduction, then a fixpoint on the block's own
    (block, block) submatrix, with one convergence check per round for the
    whole batch.
    """
    b, k, _ = iou.shape
    pad = (-k) % block
    kp = k + pad
    supp = iou > iou_thr
    if pad:
        supp = torch.nn.functional.pad(supp, (0, pad, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    idx = torch.arange(kp, device=iou.device)
    supp = supp & (idx[:, None] < idx[None, :])              # S[j, i], j < i
    supp = supp.float()
    keep = torch.zeros((b, kp), dtype=torch.bool, device=iou.device)
    for start in range(0, kp, block):
        cols = supp[:, :, start:start + block]                # (B, Kp, blk)
        ext = torch.bmm(keep.float()[:, None, :], cols)[:, 0] > 0
        init = valid[:, start:start + block] & ~ext
        sub = cols[:, start:start + block]                    # (B, blk, blk)
        kb = init
        for _ in range(block):
            nxt = init & ~(torch.bmm(kb.float()[:, None, :], sub)[:, 0] > 0)
            if torch.equal(nxt, kb):
                break
            kb = nxt
        keep[:, start:start + block] = kb
    return keep[:, :k]


def select_candidates(mboxes, mscores, score_thr, k):
    """Top-k (position, class) candidates per image, score-descending.

    mboxes (B, N, 5) or (B, N, C, 5); mscores (B, N, C+1), background last.
    Returns boxes (B, k, 5), scores (B, k), labels (B, k), valid (B, k).
    Pairs at or below ``score_thr`` are gated to NEG_INF, so live
    candidates form a prefix; ties keep ascending index order.
    """
    b, n, cp1 = mscores.shape
    c = cp1 - 1
    scores = mscores[..., :c]
    if mboxes.dim() == 3:
        boxes = mboxes[:, :, None, :].expand(b, n, c, 5)
    else:
        boxes = mboxes
    flat_scores = scores.reshape(b, n * c)
    flat_boxes = boxes.reshape(b, n * c, 5)
    gated = torch.where(flat_scores > score_thr, flat_scores,
                        torch.full_like(flat_scores, NEG_INF))
    k = min(k, n * c)
    top_scores, top_idx = torch.sort(gated, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = flat_boxes.gather(1, top_idx[..., None].expand(-1, -1, 5))
    top_labels = top_idx % c
    return top_boxes, top_scores, top_labels, top_scores > NEG_INF / 2


def nms_core_presorted(boxes, valid, labels, iou_thr, max_out,
                       negate_angle=False, kernels=True):
    """Label-gated greedy NMS on score-sorted candidates (B, K).

    Returns keep_idx (B, min(K, max_out)) (kept candidates first, in score
    order, padded with -1) and the kept count (B,). ``kernels`` off takes
    the plain IoU even on CUDA tensors.
    """
    b, k, _ = boxes.shape
    if k > STREAM_THRESHOLD:
        raise NotImplementedError(
            f'NMS budget {k} > {STREAM_THRESHOLD} needs the streamed sweep, '
            f'which the port does not have yet')
    if negate_angle:
        boxes = negate_theta(boxes)
    # prefix covering every valid entry (the v3 skip may punch holes)
    ar = torch.arange(k, device=boxes.device)
    vcount = torch.where(valid, ar + 1, torch.zeros_like(ar)).amax(1)
    iou_fn = rotated_iou if kernels else rotated_iou_reference
    iou = iou_fn(boxes.contiguous(), boxes.contiguous(), upper_only=True,
                 valid_count=vcount.to(torch.int32))
    iou = torch.where(labels[:, :, None] == labels[:, None, :], iou,
                      torch.zeros_like(iou))
    keep = greedy_keep_blocked(iou, valid, iou_thr)
    rank = torch.where(keep, ar, torch.full_like(ar, k + 1))
    sel = torch.sort(rank, dim=1, stable=True).indices[:, :max_out]
    keep_idx = torch.where(keep.gather(1, sel), sel, torch.full_like(sel, -1))
    return keep_idx, keep.sum(1)


def gather_dets(boxes, scores, labels, keep_idx):
    """(B, max_out, 6) dets and (B, max_out) labels; pad rows zero / -1."""
    ok = keep_idx >= 0
    safe = keep_idx.clamp_min(0)
    dets = torch.cat([boxes.gather(1, safe[..., None].expand(-1, -1, 5)),
                      scores.gather(1, safe)[..., None]], dim=-1)
    dets = torch.where(ok[..., None], dets, torch.zeros_like(dets))
    out_labels = torch.where(ok, labels.gather(1, safe),
                             torch.full_like(safe, -1))
    return dets, out_labels


def sweep_dets(top_boxes, top_scores, top_labels, valid, iou_thr, version,
               max_num, kernels=True):
    """Greedy sweep + det gathering on score-sorted candidates."""
    if version == 'v3':
        valid = valid & (torch.minimum(top_boxes[..., 2],
                                       top_boxes[..., 3]) >= 1e-3)
    keep_idx, num = nms_core_presorted(
        top_boxes, valid, top_labels, iou_thr, max_num,
        negate_angle=version in ('v3', 'mmcv'), kernels=kernels)
    dets, labels = gather_dets(top_boxes, top_scores, top_labels, keep_idx)
    return dets, labels, num.clamp_max(max_num)


def multiclass_nms_rotated_batched(mboxes, mscores, score_thr, iou_thr,
                                   version='v1', max_num=2000, pre_topk=2000,
                                   small_k=None, return_branch=False,
                                   kernels=True):
    """Batched multiclass NMS with the adaptive exact sweep budget.

    mboxes (B, N, 5) or (B, N, C, 5); mscores (B, N, C+1). Candidates are
    the top ``pre_topk`` (position, class) pairs per image. When every
    image's live count fits in ``small_k`` (clamped to >= max_num), the
    sweep runs on that score-sorted prefix only, which gives the same keep
    sets; otherwise on all ``pre_topk``. Returns (dets (B, max_num, 6),
    labels (B, max_num), num (B,)); with ``return_branch`` also
    ``(live, 'small' | 'big' | 'single')``. ``kernels`` off takes the
    plain IoU even on CUDA tensors.
    """
    if version not in ('v1', 'v2', 'v3', 'mmcv'):
        raise ValueError(f'unknown NMS version {version!r}')
    kb = min(pre_topk, mscores.shape[1] * (mscores.shape[2] - 1))
    sel = select_candidates(mboxes, mscores, score_thr, kb)
    live = None
    if small_k is None or max(small_k, max_num) >= kb:
        branch = 'single'
    else:
        sk = max(small_k, max_num)
        live = int(sel[3].sum(1).max())          # one host sync per batch
        if live <= sk:
            branch = 'small'
            sel = tuple(t[:, :sk] for t in sel)
        else:
            branch = 'big'
    out = sweep_dets(*sel, iou_thr=iou_thr, version=version, max_num=max_num,
                     kernels=kernels)
    if return_branch:
        return out + ((live, branch),)
    return out
