"""Kernel timing and work bounds on one H100, shared by ``chip_smoke.py``
and ``tools/kernel_bench.py``.

- ``cuda_ms``: mean milliseconds a call on the card, between CUDA events;
- ``bound`` / ``add_bound``: the least time the card could take for a
  function, the larger of the bytes it must move (each input read once,
  each output written once) over the memory rate and its operations over
  the peak rate of their type;
- ``iou_work`` and ``frm_work``: those bytes and operations for K1
  (``ops/rotated_iou.py``) and K2 (``ops/frm_sample.py``) on given inputs.

The rates are the H100 SXM's published figures.
"""
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
PEAK_OPS_PER_S = {'bf16': 989e12, 'int8': 1979e12, 'f32': 67e12}
IOU_OPS_PER_PAIR = 500            # f32 operations of one pair's integral (K1)
CULL_OPS_PER_PAIR = 15            # f32 operations of K1's far-pair test


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, kind):
    """The least time the card could take, in ms, and what bounds it: the
    larger of ``nbytes`` over the memory rate and ``ops`` over the peak
    rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def add_bound(rec, nbytes, ops, kind):
    """Add one call's bound to a kernel's record (rows that sum several
    shapes sum their bounds; ``bound_by`` names the larger share)."""
    ms, by = bound(nbytes, ops, kind)
    rec['bound_ms'] = rec.get('bound_ms', 0.0) + ms
    share = rec.setdefault('_share', {'bytes': 0.0, 'operations': 0.0})
    share[by] += ms
    rec['bound_by'] = max(share, key=share.get)
    return ms, by


def iou_work(boxes, vc, out, boxes2=None):
    """K1's work on one NMS-shaped call with valid counts ``vc``: the
    dense sweep's self-IoU with ``upper_only`` (``boxes2`` None), or a
    streamed sweep's slab ``boxes`` x ``boxes2``. The live pairs (the
    upper triangle of the live prefix, or the slab's rows below ``vc``),
    the pairs its cull tests (those of the tiles the zero-fill rules
    keep), the near pairs it integrates, and its bound: the boxes read and
    ``out`` written, against IOU_OPS_PER_PAIR a near pair and
    CULL_OPS_PER_PAIR a tested one. ``bound_all_pairs_ms`` counts the
    integral for every live pair (the bound before the cull)."""
    from ..ops import rotated_iou as K1
    n = boxes.shape[1]
    upper = boxes2 is None
    other = boxes if upper else boxes2
    m = other.shape[1]
    kept = ~K1._skip_mask(n, m, upper, vc, boxes.device)
    tested = int(kept.sum())
    near = int((kept & ~K1.far_pairs(boxes, other)).sum())
    live = sum(v * (v + 1) // 2 if upper else min(v, n) * m
               for v in vc.tolist())
    nbytes = (boxes.numel() + other.numel()) * 4 + vc.numel() * 4 + \
        out.numel() * 4
    b_ms, by = bound(nbytes, near * IOU_OPS_PER_PAIR
                     + tested * CULL_OPS_PER_PAIR, 'f32')
    all_ms, _ = bound(nbytes, live * IOU_OPS_PER_PAIR, 'f32')
    return dict(live_pairs=live, tested_pairs=tested, near_pairs=near,
                near_share=near / max(tested, 1), bound_ms=b_ms,
                bound_by=by, bound_all_pairs_ms=all_ms)


def frm_work(xs, rois, points):
    """K2's bytes and operations on these inputs: x, feat and rois read,
    out written; per output value, points x (4 products, 3 sums, a
    rounding) and the points - 1 running sums and two residual adds, each
    with its rounding (f32)."""
    values = sum(x.numel() for x in xs)
    nbytes = 3 * values * 2 + sum(r.numel() for r in rois) * 4
    return nbytes, values * (8 * points + 2 * (points - 1) + 4)
