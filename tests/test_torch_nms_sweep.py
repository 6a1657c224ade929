"""The label-gated greedy sweep (``ops/nms.py::greedy_keep_gated``) on the
CPU, where it takes its plain route (the gate, then the blocked fixpoint of
``greedy_keep_blocked``).

- The public entry equals a sequential label-gated greedy loop on scenes
  with threshold ties (IoU at the f32 rounding of the threshold and one
  ulp either side), v3 holes in ``valid``, an image with nothing live and
  K no multiple of 64 or of the sweep's 256-blocks; it launches nothing
  and marks its fixpoint rounds with ``sync.fixpoint`` spans.
- The kernel's contract names why it refuses each input it does not take.

tests/test_torch_kernels_gpu.py holds the CUDA kernel (``csrc/
nms_sweep.cu``) to this plain route on a card. The scene generators here
import no JAX, so that file uses them too.
"""
import numpy as np
import pytest
import torch

from r3det_tpu_torch import _ext
from r3det_tpu_torch.ops import nms
from r3det_tpu_torch.ops.route import kernels

from program_spans import traced

torch.set_num_threads(2)
THR = 0.1


def sequential_keep(iou, valid, labels, iou_thr):
    """The greedy keep, one candidate at a time, in numpy: iou (B, K, K)
    f32, valid (B, K) bool, labels (B, K) -> keep (B, K) bool. Candidate
    a is kept iff valid and no kept j < a of its label has
    iou[j, a] > iou_thr in f32."""
    thr = np.float32(iou_thr)
    b, k = valid.shape
    keep = np.zeros((b, k), bool)
    for i in range(b):
        for a in range(k):
            if not valid[i, a]:
                continue
            kept = np.flatnonzero(keep[i, :a])
            keep[i, a] = not np.any((labels[i, kept] == labels[i, a])
                                    & (iou[i, kept, a] > thr))
    return keep


def tie_scene(rng, b, k, iou_thr=THR, labels=3):
    """(iou (B, K, K) f32, valid, labels, vcount) numpy: upper-triangle IoU
    drawn from the threshold's f32 rounding, one ulp above and below it, 0
    and 0.9 (garbage below the diagonal, as K1's tiles leave there); v3
    holes in the live prefix, each image's live count its own (the last
    image none)."""
    thr = np.float32(iou_thr)
    pick = np.array([thr, np.nextafter(thr, np.float32(1)),
                     np.nextafter(thr, np.float32(0)), 0.0, 0.9],
                    np.float32)
    iou = pick[rng.randint(0, len(pick), (b, k, k))]
    iou = np.where(np.triu(np.ones((k, k), bool), 1), iou,
                   rng.uniform(0, 1, (b, k, k)).astype(np.float32))
    vcount = rng.randint(k // 2, k + 1, b)
    vcount[-1] = 0
    live = np.arange(k)[None] < vcount[:, None]
    valid = live & (rng.uniform(size=(b, k)) > 0.1)
    return (iou.astype(np.float32), valid,
            rng.randint(0, labels, (b, k)).astype(np.int64), vcount)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def no_kernel(*args, **kwargs):
    raise AssertionError('the sweep kernel ran on the CPU')


@pytest.mark.parametrize('b,k,labels', [(3, 300, 3), (2, 77, 1),
                                        (2, 513, 5)])
def test_plain_route_is_the_sequential_greedy(monkeypatch, b, k, labels):
    """On CPU tensors the public entry takes the plain route and keeps what
    the sequential greedy loop keeps, ties and holes included."""
    monkeypatch.setattr(nms, 'greedy_keep_gated_cuda', no_kernel)
    iou, valid, lab, vcount = tie_scene(np.random.RandomState(k), b, k,
                                        labels=labels)
    before = dict(_ext.LAUNCHES)
    keep, spans = traced(lambda: nms.greedy_keep_gated(
        t(iou), t(valid), t(lab), t(vcount), THR))
    assert _ext.LAUNCHES == before
    assert keep.dtype == torch.bool and tuple(keep.shape) == (b, k)
    want = sequential_keep(iou, valid, lab, THR)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert not keep[-1].any()                     # nothing live
    assert want[:-1].any(1).all()
    rounds = [s for s in spans if s[0] == 'r3det.sync.fixpoint']
    assert len(rounds) >= -(-k // nms.BLOCK_S)


def test_dense_sweep_on_boxes_is_the_sequential_greedy(monkeypatch):
    """``greedy_keep_dense`` (IoU of clustered boxes, then the gated sweep)
    equals the loop on the IoU it saw."""
    monkeypatch.setattr(nms, 'greedy_keep_gated_cuda', no_kernel)
    rng = np.random.RandomState(5)
    b, k = 2, 160
    centres = rng.uniform(0, 300, (b, k // 4, 2)).repeat(4, 1)
    boxes = np.concatenate([centres + rng.uniform(-6, 6, (b, k, 2)),
                            rng.uniform(10, 40, (b, k, 2)),
                            rng.uniform(-1.5, 1.5, (b, k, 1))], -1)
    valid = rng.uniform(size=(b, k)) > 0.05
    valid[1, 120:] = False
    vcount = np.where(valid, np.arange(k) + 1, 0).max(1)
    lab = rng.randint(0, 2, (b, k))
    seen = []
    real = nms.greedy_keep_gated

    def spy(iou, *args):
        seen.append(iou)
        return real(iou, *args)
    monkeypatch.setattr(nms, 'greedy_keep_gated', spy)
    keep = nms.greedy_keep_dense(t(boxes.astype(np.float32)), t(valid),
                                 t(lab), THR, t(vcount))
    assert len(seen) == 1
    want = sequential_keep(seen[0].numpy(), valid, lab, THR)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def refused(case):
    """(iou, labels, iou_thr) of each input the kernel does not take."""
    iou = torch.zeros((1, 8, 8))
    lab = torch.zeros((1, 8), dtype=torch.long)
    return {'cpu': (iou, lab, THR),
            'f64': (iou.double(), lab, THR),
            'k_above_max': (torch.zeros((1, 2, nms.SWEEP_MAX_K + 1)),
                            torch.zeros((1, 2), dtype=torch.long), THR),
            'float_labels': (iou, lab.float(), THR),
            'negative_thr': (iou, lab, -0.5)}[case]


@pytest.mark.parametrize('case,why', [
    ('cpu', 'CUDA tensors'), ('f64', 'float32'),
    ('k_above_max', f'K <= {nms.SWEEP_MAX_K}'),
    ('float_labels', 'integer labels'), ('negative_thr', 'iou_thr >= 0')])
def test_contract_names_each_refusal(case, why):
    reason = nms.refusal(*refused(case))
    assert reason is not None and why in reason, reason
    with kernels(False):
        assert nms.refusal(torch.zeros((1, 8, 8)),
                           torch.zeros((1, 8), dtype=torch.long), THR) \
            == 'the kernels are switched off'


def test_cuda_wrapper_raises_with_the_reason():
    iou = torch.zeros((1, 8, 8))
    valid = torch.ones((1, 8), dtype=torch.bool)
    lab = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match='nms_sweep: .*CUDA tensors'):
        nms.greedy_keep_gated_cuda(iou, valid, lab, torch.tensor([8]), THR)


def test_negative_threshold_suppresses_across_labels():
    """Below 0 the plain gate's zeros pass the threshold, so a kept box
    suppresses every later one whatever its label: the reason the kernel
    refuses such thresholds."""
    k = 5
    keep = nms.greedy_keep_gated(
        torch.zeros((1, k, k)), torch.ones((1, k), dtype=torch.bool),
        torch.arange(k)[None], torch.tensor([k]), -0.5)
    assert keep.tolist() == [[True] + [False] * (k - 1)]
