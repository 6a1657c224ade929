"""Kernel timing and work bounds on one H100, shared by ``chip_smoke.py``
and ``tools/kernel_bench.py``.

- ``cuda_ms``: mean milliseconds a call on the card, between CUDA events;
  ``graph_ms``: the same for launches captured in a CUDA graph, so that a
  short kernel is timed without the host's pace between its launches;
- ``bound`` / ``add_bound``: the least time the card could take for a
  function, the larger of the bytes it must move (each input read once,
  each output written once) over the memory rate and its operations over
  the peak rate of their type;
- ``iou_work`` and ``frm_work``: those bytes and operations for K1
  (``ops/rotated_iou.py``) and K2 (``ops/frm_sample.py``) on given inputs;
- ``nms_sweep_work``: the bound of the NMS sweep kernel (``ops/nms.py``);
- ``r50_epilogues`` and ``epilogue_bytes``: the conv epilogues of a
  ResNet-50 forward (``ops/conv_epilogue.py``) and the bytes of one;
- ``swin_attn_work``: the bounds of Swin's two attention kernels
  (``ops/swin_attn.py``) on one block's map;
- ``lsk_attn_work`` and ``lsk_mlp_work``: the bounds of LSKNet's
  attention kernels (``ops/lsk_attn.py``) and MLP kernels
  (``ops/lsk_mlp.py``) on one block's map.

The rates are the H100 SXM's published figures.
"""
import math

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


def graph_ms(calls, iters, replays=5):
    """Mean milliseconds a launch of ``iters`` launches captured in one
    CUDA graph, taking ``calls`` in turn (each warmed up first)."""
    import torch
    for call in calls:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    return cuda_ms(graph.replay, replays) / iters


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
    return add_bound_ms(rec, *bound(nbytes, ops, kind))


def add_bound_ms(rec, ms, by):
    """``add_bound`` for a bound already in ms, bounded by ``by``."""
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


def nms_sweep_work(labels, vcount):
    """The NMS sweep kernel's bound on one call: the f32 IoU of each
    same-label pair j < i below an image's live count ``vcount`` (the only
    pairs its keep set depends on), one compare each; the labels (int64)
    and valid flags read and the keep flags written once."""
    b, k = labels.shape
    pairs = 0
    for lab, v in zip(labels, vcount.tolist()):
        counts = lab[:v].unique(return_counts=True)[1]
        pairs += int((counts * (counts - 1) // 2).sum())
    b_ms, by = bound(pairs * 4 + b * k * 10, pairs, 'f32')
    return dict(gated_pairs=pairs, bound_ms=b_ms, bound_by=by)


def frm_work(xs, rois, points):
    """K2's bytes and operations on these inputs: x, feat and rois read,
    out written; per output value, points x (4 products, 3 sums, a
    rounding) and the points - 1 running sums and two residual adds, each
    with its rounding (f32)."""
    values = sum(x.numel() for x in xs)
    nbytes = 3 * values * 2 + sum(r.numel() for r in rois) * 4
    return nbytes, values * (8 * points + 2 * (points - 1) + 4)


def r50_epilogues(batch, size):
    """The 48 conv epilogues of a ResNet-50 forward on ``batch`` images of
    ``size``^2, in call order: ((B, C, H, W), residual), ``residual``
    None, 'identity' or 'downsample' (conv3's)."""
    from ..models.resnet import STAGE_BLOCKS, WIDTHS
    calls, h = [], size // 4                    # the stem's output
    for stage, blocks in enumerate(STAGE_BLOCKS[50]):
        f = WIDTHS[stage]
        for blk in range(blocks):
            stride = 2 if (blk == 0 and stage > 0) else 1
            ho = h // stride
            calls += [((batch, f, h, h), None), ((batch, f, ho, ho), None),
                      ((batch, 4 * f, ho, ho),
                       'downsample' if blk == 0 else 'identity')]
            h = ho
    return calls


def epilogue_bytes(shape, residual):
    """One conv epilogue's bytes: the bf16 conv output read and the result
    written, the residual read, and the (C,) bf16 affines."""
    numel = math.prod(shape)
    c = shape[1]
    return numel * 2 * (3 if residual else 2) + c * 2 * (
        4 if residual == 'downsample' else 2)


SOFTMAX_OPS = 5     # f32 operations a score: scale and bias, max, exp, sum, /


def swin_attn_work(batch, h, w, c, heads, window):
    """The bounds of ``swin_norm_pad`` and ``swin_window_attn`` on a (batch,
    h, w, c) block input: {name: (bound_ms, bound_by)}. The norm reads the
    map and its f32 gain and shift and writes the padded map; the attention
    reads the padded map's qkv and the bias table and writes the map, and
    does QK^T and PV on the tensor cores (bf16) and the softmax in f32."""
    hp, wp = (-(-h // window) * window, -(-w // window) * window)
    n = window * window
    scores = batch * (hp // window) * (wp // window) * heads * n * n
    norm = bound(2 * batch * (h * w + hp * wp) * c + 8 * c, 0, 'bf16')
    nbytes = 2 * batch * (3 * hp * wp + h * w) * c \
        + 4 * (2 * window - 1) ** 2 * heads
    tc = bound(nbytes, 2 * 2 * scores * (c // heads), 'bf16')
    f32 = bound(0, SOFTMAX_OPS * scores, 'f32')
    return {'swin_norm_pad': norm, 'swin_window_attn': max(tc, f32)}


GELU_OPS = 8        # f32 operations an exact GELU (fewer than any erf takes)
SIGMOID_OPS = 4     # f32 operations a sigmoid
TAPS_A, TAPS_B = 25, 49   # conv0's and conv_spatial's taps a channel


def lsk_attn_work(batch, h, w, c):
    """The bounds of LSKNet's five attention kernels on a (batch, h, w, c)
    block map: {name: (bound_ms, bound_by)}. Each reads its maps and
    parameters once and writes its output once (bf16 maps, float32 taps
    and selection parameters, bf16 vectors); float32 operations on the
    CUDA cores, a multiply-add two: the taps (25 + 49 a channel) and their
    biases; the selection's bias adds, sums, maxes, ``conv_squeeze``
    (2 x 2 x 49), sigmoids and weighted sum; the epilogues' bias add and
    GELU, gate, or shortcut (BN's multiply-add) and layer-scaled residual
    (two adds, a multiply-add)."""
    n = batch * h * w
    half = c // 2
    return {
        'lsk_taps': bound(2 * n * 3 * c + 4 * (76 * c),
                          n * c * (2 * (TAPS_A + TAPS_B) + 2), 'f32'),
        'lsk_select': bound(2 * n * (c + half) + 4 * (c + 198),
                            n * (3 * c + 2 * 2 * 2 * 49 + 2
                                 + 2 * SIGMOID_OPS + 3 * half), 'f32'),
        'lsk_bias_gelu': bound(2 * n * 2 * c + 2 * c,
                               n * c * (1 + GELU_OPS), 'f32'),
        'lsk_bias_gate': bound(2 * n * 3 * c + 2 * c, n * c * 2, 'f32'),
        'lsk_bias_residual': bound(2 * n * 3 * c + 8 * c, n * c * 7, 'f32'),
    }


DW_TAPS = 9         # dwconv's taps a hidden channel (3x3)


def lsk_mlp_work(batch, h, w, c, hidden):
    """The bounds of LSKNet's two MLP kernels on a (batch, h, w, c) block
    map of ``hidden`` hidden channels: {name: (bound_ms, bound_by)}, as
    :func:`lsk_attn_work` counts them. ``lsk_dw_gelu`` reads the hidden
    map, its float32 taps and bias and fc1's bf16 bias, and writes the
    hidden map; fc1's bias add, the taps and their bias, and GELU on the
    CUDA cores.
    ``lsk_bias_scale`` reads fc2's product and x and writes the output;
    the bias add and the layer-scaled residual (a multiply-add)."""
    n = batch * h * w
    return {
        'lsk_dw_gelu': bound(2 * n * 2 * hidden + 4 * (DW_TAPS + 1) * hidden
                             + 2 * hidden,
                             n * hidden * (1 + 2 * DW_TAPS + 1 + GELU_OPS),
                             'f32'),
        'lsk_bias_scale': bound(2 * n * 3 * c + 4 * c, n * c * 3, 'f32'),
    }
