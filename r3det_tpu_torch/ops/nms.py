"""Rotated NMS (v1/v2/v3/mmcv and poly), static output shapes.

Port of ``r3det_tpu/ops/nms.py``: the batched serving path
(``_select_candidates``, ``_nms_core``, ``_greedy_keep_blocked``,
``_greedy_keep_streamed``, ``_gather_dets``, ``_sweep_dets``,
``multiclass_nms_rotated_batched``) and the single-image family (``rnms``,
``batched_rnms``, ``ml_nms_rotated``, ``obb_batched_nms``, ``poly_nms``,
``multiclass_nms_rotated``), each one image as a batch of 1 through the
same core. Every version is one label-gated greedy pass (cross-class IoU
is zero); the version picks only the angle convention (v3/mmcv negate
theta) and the v3 tiny-box skip.

Differences from the JAX form, none of which changes a keep set:

- everything is batched over images explicitly (no vmap);
- ties in score order follow ascending index, as JAX's ``lax.top_k`` and
  stable ``argsort`` do: every sort here is ``stable=True``;
- the adaptive budget's ``lax.cond`` is one host ``if`` on the live count,
  one device-to-host sync per batch;
- the greedy sweep checks convergence once per round for all images;
- the pairwise IoU is :func:`~r3det_tpu_torch.ops.rotated_iou.rotated_iou`
  (the K1 kernel on CUDA tensors): the (B, K, K) matrix up to
  ``STREAM_THRESHOLD`` candidates, above it one (B, K, ``STREAM_BLOCK``)
  slab per block of candidates (:func:`greedy_keep_streamed`);
- on that matrix the label-gated sweep is :func:`greedy_keep_gated`: the
  CUDA kernel ``csrc/nms_sweep.cu`` where :func:`refusal` holds (one pass
  over a bitmask of the gated, thresholded upper triangle, no host sync),
  the blocked fixpoint of :func:`greedy_keep_blocked` otherwise.
"""
import torch

from .. import _ext
from ..utils.tracing import span
from . import route
from .rotated_iou import negate_theta, quad_iou_pairwise, rotated_iou

NEG_INF = -1e30
BLOCK_S = 256
# candidate budgets above this stream (K, STREAM_BLOCK) IoU slabs instead
# of building the (K, K) matrix (8 x 8000^2 f32 is 2 GB)
STREAM_THRESHOLD = 4096
STREAM_BLOCK = 512
# the sweep kernel keeps an image's suppressed columns in 64 words of 64 bits
SWEEP_MAX_K = 4096


def _resolve_block(cols, keep, vblk, start, block):
    """One block of the blocked greedy sweep, batched.

    cols (B, Kp, blk) f32 0/1: S[j, start + i] (j suppresses start + i,
    j < start + i); keep (B, Kp) bool: the final keeps of earlier blocks
    (False from ``start`` on); vblk (B, blk) bool. Suppression from
    earlier blocks in one masked reduction, then a fixpoint on the block's
    own (blk, blk) submatrix, one convergence check per round for the
    whole batch (a host sync, span ``sync.fixpoint``). Returns the block's
    keep (B, blk)."""
    ext = torch.bmm(keep.float()[:, None, :], cols)[:, 0] > 0
    init = vblk & ~ext
    sub = cols[:, start:start + block]                        # (B, blk, blk)
    kb = init
    for _ in range(block):
        nxt = init & ~(torch.bmm(kb.float()[:, None, :], sub)[:, 0] > 0)
        with span('sync.fixpoint'):
            same = torch.equal(nxt, kb)
        if same:
            break
        kb = nxt
    return kb


def greedy_keep_blocked(iou, valid, iou_thr, block=BLOCK_S):
    """Exact greedy suppression over score-sorted boxes, batched.

    iou (B, K, K), valid (B, K) bool -> keep (B, K) bool. Blocks of
    ``block`` boxes go in score order (:func:`_resolve_block`).
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
        keep[:, start:start + block] = _resolve_block(
            supp[:, :, start:start + block], keep,
            valid[:, start:start + block], start, block)
    return keep[:, :k]


def greedy_keep_gated_reference(iou, valid, labels, vcount, iou_thr):
    """The plain form of :func:`greedy_keep_gated`: the IoU gated to zero
    across labels, then :func:`greedy_keep_blocked` (``vcount`` bounds only
    the kernel's work)."""
    iou = torch.where(labels[:, :, None] == labels[:, None, :], iou,
                      torch.zeros_like(iou))
    return greedy_keep_blocked(iou, valid, iou_thr)


def refusal(iou, labels, iou_thr):
    """The sweep kernel's contract (``ops/route.py``): a float32 IoU of at
    most ``SWEEP_MAX_K`` candidates, integer labels and ``iou_thr`` >= 0
    (below 0 the plain gate's zeros would suppress across labels)."""
    if iou.shape[-1] > SWEEP_MAX_K:
        return f'the kernel takes K <= {SWEEP_MAX_K}, not {iou.shape[-1]}'
    if labels.is_floating_point() or labels.is_complex():
        return f'the kernel compares integer labels, not {labels.dtype}'
    if iou_thr < 0:
        return f'the kernel takes iou_thr >= 0, not {iou_thr}'
    return route.refusal(iou, iou.dtype, want=torch.float32)


def greedy_keep_gated_cuda(iou, valid, labels, vcount, iou_thr):
    """Launch the sweep kernel (``csrc/nms_sweep.cu``) on CUDA tensors:
    iou (B, K, K) f32, valid (B, K) bool, labels (B, K) integer, vcount
    (B,) with every valid candidate below it -> keep (B, K) bool."""
    route.check(refusal(iou, labels, iou_thr), 'nms_sweep')
    b, k = iou.shape[0], iou.shape[-1]
    for name, t, shape in (('iou', iou, (b, k, k)), ('valid', valid, (b, k)),
                           ('labels', labels, (b, k)),
                           ('vcount', vcount, (b,))):
        if tuple(t.shape) != shape or t.device != iou.device:
            raise ValueError(f'{name} must have shape {shape} on {iou.device}'
                             f', got {tuple(t.shape)} on {t.device}')
    if valid.dtype != torch.bool:
        raise ValueError(f'valid must be bool, not {valid.dtype}')
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if b == 0 or k == 0:
        return keep
    iou = iou.contiguous()
    labels = labels.to(torch.int64).contiguous()
    valid = valid.contiguous()
    vcount = vcount.to(torch.int32).contiguous()
    mask = torch.empty((b, k, -(-k // 64)), dtype=torch.int64,
                       device=iou.device)
    _ext.launch('nms_sweep', iou.data_ptr(), labels.data_ptr(),
                valid.data_ptr(), vcount.data_ptr(), float(iou_thr),
                mask.data_ptr(), keep.data_ptr(), b, k,
                _ext.current_stream(iou.device))
    return keep


def greedy_keep_gated(iou, valid, labels, vcount, iou_thr):
    """Label-gated greedy keep (B, K) of score-sorted candidates from
    their (B, K, K) IoU (only j < i pairs are read; tiles past ``vcount``
    may be zero): the kernel where :func:`refusal` holds, the plain form
    otherwise. The same set either way."""
    if refusal(iou, labels, iou_thr) is None:
        return greedy_keep_gated_cuda(iou, valid, labels, vcount, iou_thr)
    return greedy_keep_gated_reference(iou, valid, labels, vcount, iou_thr)


def greedy_keep_dense(boxes, valid, labels, iou_thr, vcount):
    """Label-gated greedy keep of score-sorted candidates (B, K) from the
    whole (B, K, K) IoU: one IoU call (K1 on a card, ``upper_only``,
    tiles past ``vcount`` (B,) skipped), then :func:`greedy_keep_gated`.
    """
    vcount = vcount.to(torch.int32)
    iou = rotated_iou(boxes.contiguous(), boxes.contiguous(),
                      upper_only=True, valid_count=vcount)
    return greedy_keep_gated(iou, valid, labels, vcount, iou_thr)


def greedy_keep_streamed(boxes, valid, labels, iou_thr, vcount,
                         block=STREAM_BLOCK):
    """:func:`greedy_keep_dense`'s keep set without the (B, K, K) matrix.

    K is padded to a multiple of ``block`` (labels -2). Each block of
    ``block`` sorted candidates takes one IoU call of all (B, Kp, 5)
    candidates against the block's (B, block, 5), tiles past
    ``min(vcount, start + block)`` skipped (the rows greedy reads are the
    j < i ones); then the label gate, the suppression by earlier blocks'
    keeps and the block's own fixpoint (:func:`_resolve_block`). Peak
    memory O(B * K * block).
    """
    b, k, _ = boxes.shape
    pad = (-k) % block
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-2)
    kp = k + pad
    boxes = boxes.contiguous()
    row = torch.arange(kp, device=boxes.device)
    keep = torch.zeros((b, kp), dtype=torch.bool, device=boxes.device)
    for start in range(0, kp, block):
        stop = start + block
        cols = rotated_iou(boxes, boxes[:, start:stop].contiguous(),
                           valid_count=vcount.clamp_max(stop).to(torch.int32))
        cols = torch.where(labels[:, :, None] == labels[:, None, start:stop],
                           cols, torch.zeros_like(cols))
        supp = (cols > iou_thr) & (row[:, None] < row[None, start:stop])
        keep[:, start:stop] = _resolve_block(
            supp.float(), keep, valid[:, start:stop], start, block)
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
                       negate_angle=False):
    """Label-gated greedy NMS on score-sorted candidates (B, K).

    Returns keep_idx (B, min(K, max_out)) (kept candidates first, in score
    order, padded with -1) and the kept count (B,). Budgets above
    ``STREAM_THRESHOLD`` take the streamed sweep.
    """
    k = boxes.shape[1]
    ar = torch.arange(k, device=boxes.device)
    if k == 0:
        return _keep_indices(valid, max_out)
    if negate_angle:
        boxes = negate_theta(boxes)
    # prefix covering every valid entry (the v3 skip may punch holes)
    vcount = torch.where(valid, ar + 1, torch.zeros_like(ar)).amax(1)
    sweep = greedy_keep_streamed if k > STREAM_THRESHOLD \
        else greedy_keep_dense
    keep = sweep(boxes, valid, labels, iou_thr, vcount)
    return _keep_indices(keep, max_out)


def _keep_indices(keep, max_out):
    """keep (B, K) bool -> the kept indices (B, min(K, max_out)), first and
    in order, padded with -1, and the kept count (B,)."""
    k = keep.shape[1]
    ar = torch.arange(k, device=keep.device)
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
               max_num):
    """Greedy sweep + det gathering on score-sorted candidates."""
    if version not in ('v1', 'v2', 'v3', 'mmcv'):
        raise ValueError(f'unknown NMS version {version!r}')
    if version == 'v3':
        valid = valid & (torch.minimum(top_boxes[..., 2],
                                       top_boxes[..., 3]) >= 1e-3)
    keep_idx, num = nms_core_presorted(
        top_boxes, valid, top_labels, iou_thr, max_num,
        negate_angle=version in ('v3', 'mmcv'))
    dets, labels = gather_dets(top_boxes, top_scores, top_labels, keep_idx)
    return dets, labels, num.clamp_max(max_num)


def multiclass_nms_rotated_batched(mboxes, mscores, score_thr, iou_thr,
                                   version='v1', max_num=2000, pre_topk=2000,
                                   small_k=None):
    """Batched multiclass NMS with the adaptive exact sweep budget.

    mboxes (B, N, 5) or (B, N, C, 5); mscores (B, N, C+1). Candidates are
    the top ``pre_topk`` (position, class) pairs per image. When every
    image's live count fits in ``small_k`` (clamped to >= max_num), the
    sweep runs on that score-sorted prefix only, which gives the same keep
    sets; otherwise on all ``pre_topk``. Returns (dets (B, max_num, 6),
    labels (B, max_num), num (B,)). Spans: ``nms`` around the whole,
    ``sync.budget``
    around the live count's read, and the sweep in ``nms.sweep.single``,
    ``.small`` or ``.big``, named by the budget's branch.
    """
    with span('nms'):
        kb = min(pre_topk, mscores.shape[1] * (mscores.shape[2] - 1))
        sel = select_candidates(mboxes, mscores, score_thr, kb)
        if small_k is None or max(small_k, max_num) >= kb:
            branch = 'single'
        else:
            sk = max(small_k, max_num)
            live = sel[3].sum(1).max()
            with span('sync.budget'):
                live = int(live)                 # one host sync per batch
            if live <= sk:
                branch = 'small'
                sel = tuple(t[:, :sk] for t in sel)
            else:
                branch = 'big'
        with span('nms.sweep.' + branch):
            return sweep_dets(*sel, iou_thr=iou_thr, version=version,
                              max_num=max_num)


# ---------------------------------------------------------------------------
# The single-image family: one image as a batch of 1 through the same core
# ---------------------------------------------------------------------------

def _nms_single(boxes, scores, iou_thr, max_out, valid=None, labels=None,
                negate_angle=False):
    """JAX's ``_nms_core`` on one image: sort (valid first, score
    descending, ties in ascending index), sweep, and map back. Returns
    keep_idx (min(N, max_out),) into the inputs, kept first in score order,
    padded with -1, and the kept count (not clamped to max_out)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    if labels is None:
        labels = torch.zeros(scores.shape, dtype=torch.long,
                             device=scores.device)
    key = torch.where(valid, -scores, torch.full_like(scores, float('inf')))
    order = torch.sort(key, stable=True).indices
    keep_idx, num = nms_core_presorted(
        boxes[order][None], valid[order][None], labels[order][None], iou_thr,
        max_out, negate_angle=negate_angle)
    return _unsort(keep_idx[0], order), num[0]


def _unsort(keep_idx, order):
    """Indices into the sorted candidates -> into the inputs (-1 stays)."""
    return torch.where(keep_idx >= 0, order[keep_idx.clamp_min(0)],
                       torch.full_like(keep_idx, -1))


def _gather_single(boxes, scores, labels, keep_idx):
    dets, out_labels = gather_dets(boxes[None], scores[None], labels[None],
                                   keep_idx[None])
    return dets[0], out_labels[0]


def rnms(dets, iou_thr, max_out=2000, negate_angle=False):
    """Single-class rotated NMS on (N, 6) scored dets: (keep_idx
    (min(N, max_out),) padded with -1 in score order, the kept count).
    ``negate_angle`` takes the v3 backend's angle convention."""
    return _nms_single(dets[:, :5], dets[:, 5], iou_thr, max_out,
                       negate_angle=negate_angle)


def batched_rnms(boxes, scores, labels, iou_thr, max_out=2000):
    """v1 multi-class NMS (label gating gives the reference's class-offset
    keep sets): ((dets (min(N, max_out), 6), labels), the kept count);
    padded rows zero, labels -1."""
    keep_idx, num = _nms_single(boxes, scores, iou_thr, max_out,
                                labels=labels)
    return _gather_single(boxes, scores, labels, keep_idx), num


def ml_nms_rotated(boxes, scores, labels, iou_thr, max_out=2000):
    """v2 multi-class NMS: IoU gated to zero across labels; the outputs of
    :func:`batched_rnms`."""
    return batched_rnms(boxes, scores, labels, iou_thr, max_out)


def obb_batched_nms(boxes, scores, labels, iou_thr, max_out=2000,
                    small_box_thr=1e-3):
    """v3 multi-class NMS: boxes with min(w, h) below ``small_box_thr``
    skipped, the detectron2/mmcv angle convention; the outputs of
    :func:`batched_rnms`."""
    valid = torch.minimum(boxes[:, 2], boxes[:, 3]) >= small_box_thr
    keep_idx, num = _nms_single(boxes, scores, iou_thr, max_out,
                                valid=valid, labels=labels,
                                negate_angle=True)
    return _gather_single(boxes, scores, labels, keep_idx), num


def poly_nms(polys_scored, iou_thr, max_out=2000):
    """Greedy NMS on scored convex quads (N, 9), by
    :func:`~r3det_tpu_torch.ops.rotated_iou.quad_iou_pairwise` (plain torch
    ops): (keep_idx (min(N, max_out),) padded with -1, the kept count)."""
    polys, scores = polys_scored[:, :8], polys_scored[:, 8]
    order = torch.sort(-scores, stable=True).indices
    polys_s = polys[order]
    iou = quad_iou_pairwise(polys_s, polys_s)
    valid = torch.ones((1, polys.shape[0]), dtype=torch.bool,
                       device=polys.device)
    keep_idx, num = _keep_indices(
        greedy_keep_blocked(iou[None], valid, iou_thr), max_out)
    return _unsort(keep_idx[0], order), num[0]


def multiclass_nms_rotated(mboxes, mscores, score_thr, iou_thr,
                           version='v1', max_num=2000, pre_topk=2000,
                           approx_topk=False):
    """Multiclass rotated NMS of one image: mboxes (N, 5) or (N, C, 5),
    mscores (N, C+1) (background last). The top ``pre_topk`` (position,
    class) pairs above ``score_thr`` compete. Returns (dets (max_num', 6),
    labels (max_num',), num), max_num' = min(max_num, candidates).
    ``approx_topk`` is TPU-only and raises."""
    if approx_topk:
        raise NotImplementedError('approx_topk is TPU-only; the port '
                                  'selects candidates exactly')
    sel = select_candidates(mboxes[None], mscores[None], score_thr, pre_topk)
    dets, labels, num = sweep_dets(*sel, iou_thr=iou_thr, version=version,
                                   max_num=max_num)
    return dets[0], labels[0], num[0]
