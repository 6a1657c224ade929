"""Each kernel's work, counted from the problem it solves, and its least
time on one H100 SXM (the published rates; a copy of the program's
``utils/kernel_timing.py`` rule, kept here so that the yardstick does not
move with the program).

- ``bound``: the larger of the bytes over the memory rate and the
  operations over the peak rate of their type;
- ``iou_work``: K1, the rotated IoU of NMS. The problem is the IoU of every
  pair of live candidates j < i of an image (the upper triangle of the
  live prefix, not the (B, K, K) buffer the kernel fills): each pair takes
  a far-pair test on the circumcircles, and the pairs whose circumcircles
  meet take the Gauss-Green integral. Bytes: the live boxes read once and
  each pair's IoU written once (f32);
- ``stem_work``: K3, the stem. The 7x7/s2 conv (3 -> 64 channels) of the
  published ResNet, its BN and ReLU, and the 3x3/s2 max-pool: bf16 image
  read, bf16 pooled map written, the weights read.
"""
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bf16': 989e12, 'int8': 1979e12, 'f32': 67e12}
IOU_OPS_PER_PAIR = 500            # f32 operations of one pair's integral
CULL_OPS_PER_PAIR = 15            # f32 operations of the far-pair test


def bound(nbytes, ops, kind):
    """(least seconds, 'bytes' | 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def near_pairs(boxes, live):
    """Pairs j < i among the first ``live`` boxes (N, 5) whose circumcircles
    meet (d^2 <= (r1 + r2)^2), counted in row blocks."""
    import torch
    b = boxes[:live].double()
    r = 0.5 * torch.sqrt(b[:, 2] ** 2 + b[:, 3] ** 2)
    count = 0
    for s in range(0, live, 1024):
        rows = b[s:s + 1024]
        d2 = (rows[:, None, 0] - b[None, :, 0]) ** 2 + \
            (rows[:, None, 1] - b[None, :, 1]) ** 2
        meet = d2 <= (r[s:s + 1024, None] + r[None, :]) ** 2
        j = torch.arange(s, s + rows.shape[0], device=b.device)[:, None]
        i = torch.arange(live, device=b.device)[None, :]
        count += int((meet & (j < i)).sum())
    return count


def iou_work(live_counts, near):
    """K1's bytes and operations for images with ``live_counts`` live
    candidates and ``near`` meeting pairs in all."""
    pairs = sum(v * (v - 1) // 2 for v in live_counts)
    nbytes = sum(live_counts) * 5 * 4 + pairs * 4
    ops = pairs * CULL_OPS_PER_PAIR + near * IOU_OPS_PER_PAIR
    return nbytes, ops


def stem_work(batch, h, w):
    """K3's bytes and operations for a batch of h x w RGB images."""
    ho, wo = h // 2, w // 2
    ops = 2 * batch * ho * wo * 64 * 7 * 7 * 3 + 4 * batch * ho * wo * 64 \
        + 8 * batch * (ho // 2) * (wo // 2) * 64
    nbytes = batch * h * w * 3 * 2 + batch * (ho // 2) * (wo // 2) * 64 * 2 \
        + 7 * 7 * 3 * 64 * 2 + 2 * 64 * 4
    return nbytes, ops
