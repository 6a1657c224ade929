"""Each CUDA kernel of r3det_tpu_torch against its plain PyTorch version, on
a card. Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Every test skips without a CUDA card (decided in the fixture). f32
comparisons run with TF32 off.
"""
import math

import numpy as np
import pytest
import torch

from r3det_tpu_torch import _ext
from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, DetectorConfig,
                                              TestCfg, build_detector,
                                              use_kernels)
from r3det_tpu_torch.models.resnet import (STAGE_BLOCKS, Bottleneck, FrozenBN,
                                           ResNet)
from r3det_tpu_torch.ops import bottleneck_fuse as K5
from r3det_tpu_torch.ops import conv_epilogue as E
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.ops import int8_conv as Q
from r3det_tpu_torch.ops import lsk_attn as L
from r3det_tpu_torch.ops import nms
from r3det_tpu_torch.ops import rotated_iou as K1
from r3det_tpu_torch.ops import stem_pool as K3
from r3det_tpu_torch.ops import swin_attn as A
from r3det_tpu_torch.ops.route import kernels
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.convert import seeded_state_dict

from program_spans import sweep_branch, traced
from test_torch_nms_sweep import sequential_keep, tie_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', torch.cuda.current_device())


def boxes(rng, b, n):
    out = np.stack([rng.uniform(0, 200, (b, n)), rng.uniform(0, 200, (b, n)),
                    rng.uniform(5, 60, (b, n)), rng.uniform(5, 60, (b, n)),
                    rng.uniform(-math.pi, math.pi, (b, n))], -1)
    out[:, 1] = out[:, 0]                             # identical pair
    return torch.from_numpy(out.astype(np.float32))


def corner_pairs(rng, n):
    """n box pairs placed corner to corner, their circumcircles (1 + eps)
    x (r1 + r2) apart: eps from 1e-7 to 1e-3 and around K1's cull margin,
    random and near-axis angles, slivers (a side of 1e-3 or 1e3). Returns
    two (n, 5) f32 arrays; pair k is (a[k], b[k])."""
    sides = np.array([1e-3, 1e3, 4.0, 160.0])
    w, h = (np.where(rng.uniform(size=(2, n)) < 0.3,
                     rng.choice(sides, (2, n)), rng.uniform(4, 160, (2, n)))
            for _ in range(2))
    axis = np.array([0.0, 1e-7, -1e-7, math.pi / 2, math.pi / 2 - 1e-6,
                     -math.pi / 2 + 1e-7, math.pi / 4])
    t = np.where(rng.uniform(size=n) < 0.5, rng.choice(axis, n),
                 rng.uniform(-math.pi, math.pi, n))
    eps = rng.permutation(np.concatenate([
        np.geomspace(1e-7, 1e-3, n - n // 4),
        rng.uniform(4.8e-4, 5.0e-4, n // 4)]))     # d^2 margin is 2^-10
    sx, sy = np.array([-1, 1, 1, -1]), np.array([-1, -1, 1, 1])
    ka, kb = rng.randint(4, size=(2, n))
    # a's corner ka points along phi; b's corner kb points back at it
    phi = t + np.arctan2(sy[ka] * h[0], sx[ka] * w[0])
    dist = (1 + eps) * 0.5 * (np.hypot(w[0], h[0]) + np.hypot(w[1], h[1]))
    ca = rng.uniform(0, 1024, (2, n))
    a = np.stack([ca[0], ca[1], w[0], h[0], t], -1)
    b = np.stack([ca[0] + dist * np.cos(phi), ca[1] + dist * np.sin(phi),
                  w[1], h[1],
                  phi + math.pi - np.arctan2(sy[kb] * h[1], sx[kb] * w[1])],
                 -1)
    swap = rng.uniform(size=(n, 1)) < 0.5       # the near-axis box on b
    return (np.where(swap, b, a).astype(np.float32),
            np.where(swap, a, b).astype(np.float32))


def assert_iou_exact(got, want):
    """K1 against its plain version: every bit, NaN where it is NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize('n,m', [(70, 90), (300, 300)])
def test_rotated_iou_kernel_matches_plain(cuda, n, m):
    rng = np.random.RandomState(n)
    b1, b2 = boxes(rng, 2, n).to(cuda), boxes(rng, 2, m).to(cuda)
    vc = torch.tensor([n, n // 3], dtype=torch.int32, device=cuda)
    before = _ext.LAUNCHES['rotated_iou']
    for args, kw in (((b1, b2), {}), ((b1, b2), dict(mode='iof')),
                     ((b1, b1), dict(upper_only=True, valid_count=vc))):
        got = K1.rotated_iou(*args, **kw)
        want = K1.rotated_iou_reference(*args, **kw)
        assert torch.equal(got, want)
    assert _ext.LAUNCHES['rotated_iou'] == before + 3


@pytest.mark.gpu
def test_rotated_iou_kernel_streamed_slab(cuda):
    """K1 on the streamed sweep's slabs: all (B, K, 5) candidates against
    one block of 512, ``valid_count`` min(vcount, start + 512), K no
    multiple of the tiles; bit-equal to its plain version."""
    rng = np.random.RandomState(11)
    b1 = boxes(rng, 3, 2600).to(cuda)
    vcount = (2600, 1700, 0)
    before = _ext.LAUNCHES['rotated_iou']
    for start in (0, 1024, 2048):
        b2 = b1[:, start:start + 512].contiguous()
        vc = torch.tensor([min(v, start + 512) for v in vcount],
                          dtype=torch.int32, device=cuda)
        got = K1.rotated_iou(b1, b2, valid_count=vc)
        assert tuple(got.shape) == (3, 2600, b2.shape[1])
        assert_iou_exact(got, K1.rotated_iou_reference(b1, b2,
                                                       valid_count=vc))
    assert _ext.LAUNCHES['rotated_iou'] == before + 3


@pytest.mark.gpu
def test_streamed_sweep_kernel_matches_plain(cuda):
    """The streamed sweep with K1 keeps what its plain route and the dense
    sweep keep (a dead tail, a hole, labels), one K1 launch a block; the
    batched multiclass NMS above STREAM_THRESHOLD the same both ways."""
    rng = np.random.RandomState(12)
    k = 2600
    b = boxes(rng, 2, k).to(cuda)
    valid = torch.ones((2, k), dtype=torch.bool, device=cuda)
    valid[0, 2000:] = False
    valid[1, 150] = False
    labels = torch.from_numpy(rng.randint(0, 4, (2, k))).to(cuda)
    vcount = torch.tensor([2000, k], device=cuda)
    before = _ext.LAUNCHES['rotated_iou']
    keep = nms.greedy_keep_streamed(b, valid, labels, 0.2, vcount)
    assert _ext.LAUNCHES['rotated_iou'] == before + math.ceil(k / 512)
    with kernels(False):
        plain = nms.greedy_keep_streamed(b, valid, labels, 0.2, vcount)
    assert torch.equal(keep, plain)
    assert torch.equal(keep, nms.greedy_keep_dense(b, valid, labels, 0.2,
                                                   vcount))
    assert keep.any(1).all()
    n, c = 2000, 3
    mboxes = boxes(rng, 2, n).to(cuda)
    mscores = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (2, n, c)), np.zeros((2, n, 1))], -1)
        .astype(np.float32)).to(cuda)
    args = dict(score_thr=0.05, iou_thr=0.1, max_num=500, pre_topk=5000)
    got = nms.multiclass_nms_rotated_batched(mboxes, mscores, **args)
    with kernels(False):
        want = nms.multiclass_nms_rotated_batched(mboxes, mscores, **args)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def clustered_boxes(rng, b, n, scale=1024.0):
    """(B, N, 5) f32 numpy: objects of 5 jittered candidates each, in
    shuffled order, so that greedy NMS has chains to resolve."""
    objs = rng.uniform(0, scale, (b, -(-n // 5), 2)).repeat(5, 1)[:, :n]
    out = np.concatenate([objs + rng.uniform(-4, 4, (b, n, 2)),
                          rng.uniform(12, 60, (b, n, 2)),
                          rng.uniform(-math.pi / 2, math.pi / 2, (b, n, 1))],
                         -1)
    perm = np.argsort(rng.uniform(size=(b, n)), 1)
    return np.take_along_axis(out, perm[..., None], 1).astype(np.float32)


def sweep_case(case, rng, cuda):
    """(iou, valid, labels, vcount) on the card for one case of
    test_nms_sweep_kernel_matches_plain: K1's upper_only IoU of clustered
    candidates, a live prefix with v3 holes in it, or the tie scene."""
    if case == 'ties':
        iou, valid, labels, vcount = (torch.from_numpy(a).to(cuda) for a in
                                      tie_scene(rng, 4, 700))
        return iou, valid, labels, vcount
    b, k, live = {'dense': (8, 4000, (2900, 3100)),
                  'sparse': (8, 2000, (250, 350)),
                  'ragged': (3, 1337, (600, 1337)),
                  'vcount_0': (4, 600, (0, 600))}[case]
    vcount = rng.randint(live[0], live[1] + 1, b)
    if case == 'vcount_0':
        vcount[1::2] = 0
    if case == 'ragged':
        vcount[0] = k
    valid = (np.arange(k)[None] < vcount[:, None]) \
        & (rng.uniform(size=(b, k)) > 0.03)
    boxes = torch.from_numpy(clustered_boxes(rng, b, k)).to(cuda)
    vc = torch.from_numpy(vcount.astype(np.int32)).to(cuda)
    iou = K1.rotated_iou(boxes, boxes, upper_only=True, valid_count=vc)
    labels = torch.from_numpy(rng.randint(0, 15, (b, k))).to(cuda)
    return iou, torch.from_numpy(valid).to(cuda), labels, vc


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['dense', 'sparse', 'ragged', 'vcount_0',
                                  'ties'])
def test_nms_sweep_kernel_matches_plain(cuda, case):
    """The sweep kernel keeps what its plain route keeps, bit for bit, one
    launch a call: (8, 4000) with ~3000 live and 15 labels, (8, 2000) with
    ~300 live, K no multiple of 64, images with nothing live, v3 holes,
    IoU at the threshold's f32 rounding and one ulp either side (there also
    what the sequential loop keeps)."""
    iou, valid, labels, vcount = sweep_case(case, np.random.RandomState(3),
                                            cuda)
    before = _ext.LAUNCHES['nms_sweep']
    keep = nms.greedy_keep_gated(iou, valid, labels, vcount, 0.1)
    assert _ext.LAUNCHES['nms_sweep'] == before + 1
    want = nms.greedy_keep_gated_reference(iou, valid, labels, vcount, 0.1)
    assert torch.equal(keep, want)
    if case == 'ties':
        assert torch.equal(keep.cpu(), torch.from_numpy(sequential_keep(
            iou.cpu().numpy(), valid.cpu().numpy(), labels.cpu().numpy(),
            0.1)))
    kept = keep.sum(1).cpu()
    live = valid.sum(1).cpu()
    assert ((kept > 0) == (live > 0)).all() and (kept < live).any()


@pytest.mark.gpu
@pytest.mark.parametrize('branch', ['small', 'big'])
def test_batched_nms_sweep_kernel_on_and_off(cuda, branch):
    """multiclass_nms_rotated_batched gives the same dets, labels and
    counts with the kernels on (the sweep kernel once a call) and off, on
    both branches of the budget."""
    rng = np.random.RandomState(4)
    b, n, c = 8, 2000, 15
    mboxes = torch.from_numpy(clustered_boxes(rng, b, n)).to(cuda)
    mscores = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (b, n, c)), np.zeros((b, n, 1))], -1)
        .astype(np.float32)).to(cuda)
    args = dict(score_thr={'small': 0.99, 'big': 0.05}[branch], iou_thr=0.1,
                max_num=2000, pre_topk=4000, small_k=2000)
    before = _ext.LAUNCHES['nms_sweep']
    got, spans = traced(lambda: nms.multiclass_nms_rotated_batched(
        mboxes, mscores, **args))
    assert _ext.LAUNCHES['nms_sweep'] == before + 1
    assert sweep_branch(spans) == [branch]
    assert not [s for s in spans if s[0] == 'r3det.sync.fixpoint']
    with kernels(False):
        want = nms.multiclass_nms_rotated_batched(mboxes, mscores, **args)
    assert _ext.LAUNCHES['nms_sweep'] == before + 1
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert (got[2] > 0).all()


def iou_case(case, rng):
    """(boxes1, boxes2, valid_count or None) on the CPU for one case of
    test_rotated_iou_kernel_exact."""
    if case == 'corner_pairs':
        a, b = corner_pairs(rng, 1500)
        x = torch.from_numpy(np.concatenate([a, b]))[None]
        return x, x, None
    if case.startswith('ragged'):
        n, m = {'ragged_7x129': (7, 129), 'ragged_257x255': (257, 255),
                'ragged_300x333': (300, 333)}[case]
        return boxes(rng, 2, n), boxes(rng, 2, m), None
    if case == 'all_far':          # a 40-pixel grid of boxes of side <= 20
        g = np.arange(300) * 40.0
        x = np.stack([g % 800, g // 800 * 40, rng.uniform(1, 20, 300),
                      rng.uniform(1, 20, 300),
                      rng.uniform(-math.pi, math.pi, 300)], -1)
        x = torch.from_numpy(x.astype(np.float32))[None]
        return x, x, None
    if case == 'all_near':         # one box, repeated
        x = boxes(rng, 1, 2)[:, :1].repeat(2, 300, 1)
        return x, x, torch.tensor([300, 150], dtype=torch.int32)
    if case == 'vcount_0':
        x = boxes(rng, 2, 300)
        return x, x, torch.tensor([0, 0], dtype=torch.int32)
    assert case == 'nan_rows'      # a NaN centre and a NaN angle
    x = boxes(rng, 1, 300)
    x[0, 3, 0] = float('nan')
    x[0, 100, 4] = float('nan')
    return x, x, None


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['corner_pairs', 'ragged_7x129',
                                  'ragged_257x255', 'ragged_300x333',
                                  'all_far', 'all_near', 'vcount_0',
                                  'nan_rows'])
def test_rotated_iou_kernel_exact(cuda, case):
    """K1 bit-equal to its plain version in both modes, dense and with the
    NMS zero-fill rules, on scenes that stress the far-pair cull."""
    b1, b2, vc = iou_case(case, np.random.RandomState(7))
    b1, b2 = b1.to(cuda), b2.to(cuda)
    vc = torch.full((b1.shape[0],), b1.shape[1], dtype=torch.int32) \
        if vc is None else vc
    calls = [((b1, b2), dict(mode=mode)) for mode in ('iou', 'iof')]
    if b1.shape == b2.shape:
        calls.append(((b1, b1), dict(upper_only=True,
                                     valid_count=vc.to(cuda))))
    before = _ext.LAUNCHES['rotated_iou']
    for args, kw in calls:
        got = K1.rotated_iou(*args, **kw)
        want = K1.rotated_iou_reference(*args, **kw)
        assert_iou_exact(got, want)
        far = K1.far_pairs(*args)
        if case == 'all_far':
            assert bool(far[:, ~torch.eye(300, dtype=torch.bool,
                                          device=cuda)].all())
        if case == 'all_near':
            assert not bool(far.any())
        if case == 'nan_rows':
            assert bool(want[0, 3].isnan().all())
            assert not bool(far[0, [3, 100]].any())
    assert _ext.LAUNCHES['rotated_iou'] == before + len(calls)


def misaligned(t):
    """A contiguous copy of ``t`` that starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
def test_frm_sample_kernel_matches_plain(cuda):
    rng = np.random.RandomState(2)
    b, h, w, c, stride = 2, 16, 16, 256, 8
    rois = np.stack([rng.uniform(-20, 150, (b, h * w)),
                     rng.uniform(-20, 150, (b, h * w)),
                     rng.uniform(8, 64, (b, h * w)),
                     rng.uniform(8, 64, (b, h * w)),
                     rng.uniform(-1, 1, (b, h * w))], -1).astype(np.float32)
    rois = torch.from_numpy(rois).to(cuda)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    for quirk in (True, False):
        # same operation order and roundings as the plain form: bit-equal
        before = _ext.LAUNCHES['frm_sample']
        got = K2.frm_sample_levels_cuda([x], [feat], [rois], [1 / stride],
                                        transpose_quirk=quirk)[0]
        assert _ext.LAUNCHES['frm_sample'] == before + 1
        want = K2.frm_sample_levels_reference([x], [feat], [rois],
                                              [1 / stride],
                                              transpose_quirk=quirk)[0]
        assert torch.equal(got, want)
    # f32, a channel count that is no multiple of 8, a misaligned view:
    # the wrapper raises; the public entry takes the plain form for what
    # only the route rules out (f32, 12 channels)
    x12 = x[..., :12].contiguous()
    for args in ((x.float(), feat.float()), (x12, x12),
                 (misaligned(x), feat), (x, misaligned(feat))):
        with pytest.raises(ValueError):
            K2.frm_sample_levels_cuda([args[0]], [args[1]], [rois],
                                      [1 / stride])
    for args in ((x.float(), feat.float()), (x12, x12)):
        before = _ext.LAUNCHES['frm_sample']
        got = K2.frm_sample_levels([args[0]], [args[1]], [rois],
                                   [1 / stride])
        assert _ext.LAUNCHES['frm_sample'] == before
        assert torch.equal(got[0], K2.frm_sample_levels_reference(
            [args[0]], [args[1]], [rois], [1 / stride])[0])
    with pytest.raises(ValueError):                         # points=3
        K2.frm_sample_levels([x], [feat], [rois], [1 / stride], 3)


def frm_edge_coords(rng, n, h, w, stride):
    """n image coordinates on an h x w level: on exact cell edges (sample
    coordinates -1, 0, integers, h - 1, h, w - 1, w), just inside and
    outside the (-1, h) and (-1, w) bounds, and far off."""
    edges = [-1.0, -1.0 + 2 ** -10, -1.0 - 2 ** -10, 0.0, 1.0]
    for size in (h, w):
        edges += [size / 2, size - 1.0, size - 2 ** -10, size,
                  size + 2 ** -10, -3.0 * size, 4.0 * size]
    return rng.choice(np.array(edges), n) * stride


def frm_levels(rng, b, sizes, c, dev, dtype=torch.bfloat16):
    """Five levels of FRM inputs (x, feat, rois, scales), rois as
    filter_bboxes gives them (centres within two cells of their own cell,
    5% far off), a tenth of them on the edges of frm_edge_coords, some
    boxes larger than the map, and angles of exactly 0 and +-pi/2."""
    xs, feats, rois, scales = [], [], [], []
    for (h, w), stride in zip(sizes, (8, 16, 32, 64, 128)):
        n = h * w
        jj, ii = np.meshgrid(np.arange(w), np.arange(h))
        cx = (jj * stride).reshape(-1) + rng.uniform(-2, 2, (b, n)) * stride
        cy = (ii * stride).reshape(-1) + rng.uniform(-2, 2, (b, n)) * stride
        far = rng.uniform(size=(b, n)) < 0.05
        cx = np.where(far, rng.uniform(-2 * w, 3 * w, (b, n)) * stride, cx)
        cy = np.where(far, rng.uniform(-2 * h, 3 * h, (b, n)) * stride, cy)
        for coord in (cx, cy):
            edge = rng.uniform(size=(b, n)) < 0.1
            coord[edge] = frm_edge_coords(rng, int(edge.sum()), h, w, stride)
        big = rng.uniform(size=(b, n)) < 0.05
        bw = np.where(big, 8 * w * stride, rng.uniform(8, 128, (b, n)))
        bh = np.where(big, 8 * h * stride, rng.uniform(8, 128, (b, n)))
        ang = rng.uniform(-1.6, 1.6, (b, n))
        ang[rng.uniform(size=(b, n)) < 0.1] = 0.0
        ang[rng.uniform(size=(b, n)) < 0.05] = math.pi / 2
        ang[rng.uniform(size=(b, n)) < 0.05] = -math.pi / 2
        rois.append(torch.from_numpy(np.stack([cx, cy, bw, bh, ang], -1)
                                     .astype(np.float32)).to(dev))
        for out in (xs, feats):
            out.append(torch.from_numpy(rng.randn(b, h, w, c).astype(
                np.float32)).to(dev, dtype))
        scales.append(1.0 / stride)
    return xs, feats, rois, scales


# the five main-path levels of a 1024^2 patch (P3..P7, 256 channels), and
# ragged maps (no multiple of the 8 x 8 cell tile) with 264 channels (a
# second, partial 256-channel pass)
FRM_CASES = {'main': (((128, 128), (64, 64), (32, 32), (16, 16), (8, 8)),
                      256),
             'ragged': (((20, 13), (10, 7), (5, 4), (3, 2), (1, 1)), 264)}


@pytest.mark.gpu
@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
@pytest.mark.parametrize('case', list(FRM_CASES))
def test_frm_sample_levels_kernel_exact(cuda, case, points, quirk):
    """K2, all five levels in one launch, bit-equal to the plain form."""
    sizes, c = FRM_CASES[case]
    args = frm_levels(np.random.RandomState(len(case) + 2 * points + quirk),
                      2, sizes, c, cuda)
    before = _ext.LAUNCHES['frm_sample']
    got = K2.frm_sample_levels(*args, points, quirk)
    assert _ext.LAUNCHES['frm_sample'] == before + 1
    want = K2.frm_sample_levels_reference(*args, points, quirk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def plain_forward(module, monkeypatch):
    """Make ``module``'s forward run with the kernels switched off."""
    forward = module.forward

    def plain(*args, **kwargs):
        with kernels(False):
            return forward(*args, **kwargs)
    monkeypatch.setattr(module, 'forward', plain)


@pytest.mark.gpu
def test_r3det_frm_points5_runs_on_card(cuda, monkeypatch):
    """A bf16 R3Det with frm_points=5: its FRM takes K2 (one launch for
    the five levels) and equals the same model with the FRM's kernels off
    (the plain form), every output bit for bit."""
    cfg = DetectorConfig(num_classes=3, stacked_convs=2, feat_channels=32,
                         backbone_depth=10, num_refine_stages=1,
                         test=TestCfg(nms_pre=64, max_per_img=16))
    model = build_detector(cfg, dtype=torch.bfloat16, device=cuda,
                           frm_points=5)
    model.load_state_dict(seeded_state_dict(model, 0))
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(cuda)
    before = _ext.LAUNCHES['frm_sample']
    with torch.no_grad():
        out = model(images)
    assert _ext.LAUNCHES['frm_sample'] == before + 1
    plain_forward(model.frm_0, monkeypatch)
    with torch.no_grad():
        plain = model(images)
    assert _ext.LAUNCHES['frm_sample'] == before + 1
    for a, b in zip(flatten(out), flatten(plain)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def stem_args(seed, shape, dev):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.uniform(-2, 2, shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    k, s, b = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 0.1, (4, 4, 12, 64)), rng.uniform(0.5, 2, 64),
        rng.uniform(-1, 1, 64)))
    return x, k, s, b


def check_stem(got, want, quantize):
    """K3 bf16: f32 sums in another order round a few bf16 outputs the
    other way: 1e-2 + 1e-2 relative. K3 int8: exact int32 sums and the
    plain version's epilogue, in its order: bit-equal."""
    assert got.shape == want.shape
    if quantize:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


def stem_kernel_vs_plain(dev, quantize):
    x, k, s, b = stem_args(5 + quantize, (2, 64, 48, 12), dev)
    name = 'stem_conv_pool_q8' if quantize else 'stem_conv_pool'
    before = _ext.LAUNCHES[name]
    got = K3.stem_conv_pool(x, k, s, b, quantize=quantize)
    assert _ext.LAUNCHES[name] == before + 1
    ref = K3.stem_conv_pool_q8_reference if quantize else \
        K3.stem_conv_pool_reference
    assert tuple(got.shape) == (2, 32, 24, 64)
    check_stem(got, ref(x, k, s, b), quantize)


@pytest.mark.gpu
def test_stem_kernel_matches_plain(cuda):
    stem_kernel_vs_plain(cuda, False)


@pytest.mark.gpu
def test_stem_q8_kernel_matches_plain(cuda):
    stem_kernel_vs_plain(cuda, True)


# the persistent grid at shapes that stress it: more tiles (4 x 16 pooled
# outputs) than resident blocks, fewer, batch 1, and sizes that are no
# multiple of the tile
STEM_SHAPES = {'more_tiles': (3, 128, 256, 12), 'fewer_tiles': (2, 24, 40, 12),
               'batch1': (1, 64, 64, 12), 'tiny': (1, 2, 2, 12),
               'ragged': (2, 34, 50, 12), 'ragged_b1': (1, 34, 50, 12)}


@pytest.mark.gpu
@pytest.mark.parametrize('quantize', [False, True])
@pytest.mark.parametrize('case', list(STEM_SHAPES))
def test_stem_kernel_persistent_grid(cuda, case, quantize):
    shape = STEM_SHAPES[case]
    x, k, s, b = stem_args(len(case), shape, cuda)
    pack = K3.pack_stem(k, s, b, quantize)
    tiles = (-(-shape[1] // 8)) * (-(-shape[2] // 32)) * shape[0]
    blocks = 2 * _ext.sm_count(cuda)
    assert (tiles > blocks) == (case == 'more_tiles')
    got = K3.stem_conv_pool_cuda(x, pack)
    ref = K3.stem_conv_pool_q8_reference if quantize else \
        K3.stem_conv_pool_reference
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    check_stem(got, ref(x, k, s, b), quantize)


@pytest.mark.gpu
@pytest.mark.parametrize('quantize', [False, True])
def test_stem_pack_rebuilt_after_weight_update(cuda, quantize):
    """The model packs the stem once per weight version: an in-place update
    of the stem kernel and of its FrozenBN reaches the kernel."""
    model = ResNet(depth=10, dtype=torch.bfloat16, quantize=quantize).to(
        cuda)
    x, k, s, b = stem_args(9, (2, 40, 36, 12), cuda)
    with torch.no_grad():
        model.conv1.kernel.copy_(k)
        model.bn1.scale.copy_(s)
        model.bn1.bias.copy_(b)
    ref = K3.stem_conv_pool_q8_reference if quantize else \
        K3.stem_conv_pool_reference
    name = 'stem_conv_pool_q8' if quantize else 'stem_conv_pool'
    for update in (None, lambda: model.conv1.kernel.mul_(-1.5),
                   lambda: model.bn1.mean.fill_(0.25)):
        if update is not None:
            with torch.no_grad():
                update()
        before = _ext.LAUNCHES[name]
        with torch.no_grad():
            got = model.stem(x)
            want = ref(x, model.conv1.kernel, *model.stem_affine())
        assert _ext.LAUNCHES[name] == before + 1
        check_stem(got, want, quantize)


@pytest.mark.gpu
def test_f32_detector_runs_on_card(cuda):
    """An f32 R3Det with default options on the card: every kernel route
    takes its plain form (only NMS's IoU kernel, f32, runs), and forward
    and predict equal the same model's after use_kernels(model, False)."""
    cfg = DetectorConfig(num_classes=3, stacked_convs=2, feat_channels=32,
                         backbone_depth=10, num_refine_stages=1,
                         test=TestCfg(nms_pre=64, max_per_img=16))
    model = build_detector(cfg, dtype=torch.float32, device=cuda)
    model.load_state_dict(seeded_state_dict(model, 0))
    with torch.no_grad():               # scores above score_thr: detections
        model.refine_head_0.retina_cls.bias.fill_(0.0)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(cuda)
    sizes = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
    step = make_predict_step(model, cfg, sizes, img_shape=(64, 64))

    def run():
        with torch.no_grad():
            out = model(images)
        return out, step(images)
    _ext.reset_launches()
    out, dets = run()
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['stem_conv_pool'] == 0
    assert _ext.LAUNCHES['frm_sample'] == 0
    use_kernels(model, False)
    try:
        plain_out, plain_dets = run()
    finally:
        use_kernels(model, True)
    for a, b in zip(flatten(out), flatten(plain_out)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for a, b in zip(dets, plain_dets):
        assert torch.equal(a, b)
    assert int(dets[2].sum()) > 0


def flatten(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [t for v in tree for t in flatten(v)]


@pytest.mark.gpu
def test_stem_pool_kernel_matches_plain(cuda):
    """K4: a max of bf16 values, bit-equal; odd sizes cover the edges."""
    rng = np.random.RandomState(7)
    y = torch.from_numpy(rng.randn(2, 33, 46, 64).astype(np.float32)).to(
        cuda, torch.bfloat16)
    got = K3.stem_pool(y)
    assert torch.equal(got, K3.stem_pool_reference(y))
    assert tuple(got.shape) == (2, 16, 23, 64)


def bottleneck_args(rng, f, dev, shape=(2, 16, 20)):
    c4 = 4 * f
    x = torch.from_numpy(rng.normal(0, 1, shape + (c4,))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    ws = [torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))
          .to(dev) for shape, std in (
              ((1, 1, c4, f), c4 ** -0.5), ((f,), 0.1),
              ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 0.1),
              ((1, 1, f, c4), f ** -0.5), ((c4,), 0.1))]
    return x, ws


def bottleneck_amax(x, dev):
    return [x.float().abs().amax(), torch.tensor(3.0, device=dev),
            torch.tensor(2.5, device=dev)]


def check_bottleneck_bf16(got, want):
    """K5 bf16 against its plain version: f32 sums in another order round a
    few bf16 intermediates the other way: atol 0.05 (the JAX package's
    bound) + 1e-2 relative, and at least 98% of the outputs equal."""
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 0.05 + 1e-2 * want.float().abs()).all())
    assert float((diff == 0).float().mean()) >= 0.98


@pytest.mark.gpu
@pytest.mark.parametrize('f', [64, 128, 256])
def test_bottleneck_kernel_matches_plain(cuda, f):
    """K5 bf16 within its bound. W = 20 leaves a ragged 8-column tile."""
    x, ws = bottleneck_args(np.random.RandomState(f), f, cuda)
    check_bottleneck_bf16(K5.fused_bottleneck(x, *ws),
                          K5.fused_bottleneck_reference(x, *ws))


@pytest.mark.gpu
@pytest.mark.parametrize('f', [64, 128, 256])
def test_bottleneck_q8_kernel_matches_plain(cuda, f):
    """K5 int8: exact int32 sums and the plain version's f32 epilogue, in
    its order: bit-equal."""
    x, ws = bottleneck_args(np.random.RandomState(f + 1), f, cuda)
    amax = bottleneck_amax(x, cuda)
    before = _ext.LAUNCHES['bottleneck_q8']
    got = K5.fused_bottleneck_q8(x, *ws, *amax)
    want = K5.fused_bottleneck_q8_reference(x, *ws, *amax)
    assert _ext.LAUNCHES['bottleneck_q8'] == before + 1
    assert torch.equal(got, want)


# (batch, H, W): batch 1 and 3; H = 8 and 24 leave a partial band of the
# 16-row tile; W = 13 and 4 a ragged 8-column tile
BOTTLENECK_SHAPES = {'b1_h8_w13': (1, 8, 13), 'b3_h24_w20': (3, 24, 20),
                     'b1_h32_w4': (1, 32, 4), 'b3_h16_w16': (3, 16, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize('q8', [False, True], ids=['bf16', 'q8'])
@pytest.mark.parametrize('f', [64, 128, 256])
@pytest.mark.parametrize('case', sorted(BOTTLENECK_SHAPES))
def test_bottleneck_kernel_shapes(cuda, case, f, q8):
    """K5 on packed weights at batch 1 and 3 and ragged tiles: one launch a
    call; int8 bit-equal, bf16 within its bound."""
    rng = np.random.RandomState(f + len(case))
    x, ws = bottleneck_args(rng, f, cuda, BOTTLENECK_SHAPES[case])
    amax = bottleneck_amax(x, cuda) if q8 else []
    pack = K5.pack_bottleneck(*ws, *amax)
    name = 'bottleneck_q8' if q8 else 'bottleneck'
    before = _ext.LAUNCHES[name]
    got = K5.fused_bottleneck_packed(x, pack)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES[name] == before + 1
    if q8:
        assert torch.equal(got, K5.fused_bottleneck_q8_reference(x, *ws,
                                                                 *amax))
    else:
        check_bottleneck_bf16(got, K5.fused_bottleneck_reference(x, *ws))


def seeded_block(f, quantize, dev, seed):
    """A fused identity ``Bottleneck`` with numpy-seeded weights, FrozenBN
    statistics and (int8) calibrated ranges."""
    rng = np.random.RandomState(seed)
    m = Bottleneck(4 * f, f, quantize=quantize, fused=True).eval()
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith('weight'):
                fan = t[0].numel()
                v = rng.normal(0, fan ** -0.5, t.shape)
            elif name.endswith(('var', 'scale')):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith('act_absmax'):
                v = rng.uniform(2.0, 4.0, t.shape)
            else:
                v = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(np.asarray(v, np.float32)))
    return m.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize('quantize', [False, 'static'], ids=['bf16', 'q8'])
def test_bottleneck_pack_cache_on_card(cuda, quantize):
    """``Bottleneck``'s fused route packs once per weight version: a second
    call reuses the pack; a weight edit or a re-calibration repacks and
    changes the output, which stays its plain route's (int8: exactly)."""
    m = seeded_block(64, quantize, cuda, 5)
    x = torch.from_numpy(np.random.RandomState(6).normal(
        0, 1, (2, 256, 16, 24)).astype(np.float32)).to(
            cuda, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def run():
        with torch.no_grad():
            with kernels(False):
                want = m(x)
            before = dict(_ext.LAUNCHES)
            got = m(x)
        name = 'bottleneck_q8' if quantize else 'bottleneck'
        assert _ext.LAUNCHES[name] == before[name] + 1
        if quantize:
            assert torch.equal(got, want)
        else:
            check_bottleneck_bf16(got.permute(0, 2, 3, 1),
                                  want.permute(0, 2, 3, 1))
        return got

    y0 = run()
    pack = m.fused_pack()
    assert torch.equal(run(), y0) and m.fused_pack() is pack
    with torch.no_grad():
        m.conv2.weight.mul_(1.5)
    y1 = run()
    assert m.fused_pack() is not pack and not torch.equal(y1, y0)
    if quantize:
        pack = m.fused_pack()
        with torch.no_grad():
            m.conv3.act_absmax.fill_(1.0)
        assert not torch.equal(run(), y1) and m.fused_pack() is not pack


def qconv_args(rng, shape, kernel, co, int8_in, bias, dev):
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    ascale = x.float().abs().amax() / 127.0
    if int8_in:
        x = Q.quantize_act(x, ascale)
    w = torch.from_numpy(rng.normal(0, 0.1, kernel + (shape[3], co))
                         .astype(np.float32)).to(dev)
    wi, ks = Q.quantize_weights(w, axes=(0, 1, 2))
    b = torch.from_numpy(rng.normal(0, 1, co).astype(np.float32)).to(
        dev) if bias else None
    return x, ascale, wi, ks.reshape(-1), b


@pytest.mark.gpu
@pytest.mark.parametrize('shape,kernel,stride,pad,co,int8_in,bias', [
    ((2, 17, 13, 64), (3, 3), (1, 1), (1, 1), 64, False, True),
    ((2, 16, 16, 256), (1, 1), (2, 2), (0, 0), 512, True, False),
    ((2, 9, 11, 256), (1, 5), (1, 1), (0, 2), 256, False, True),
    ((2, 9, 11, 256), (5, 1), (1, 1), (2, 0), 256, False, True),
    ((1, 10, 10, 32), (3, 3), (2, 2), (1, 1), 64, True, True),
    ((2, 16, 16, 256), (1, 1), (1, 1), (0, 0), 64, True, False),
    ((1, 8, 8, 512), (1, 1), (1, 1), (0, 0), 2048, False, False),
    ((2, 13, 11, 128), (3, 3), (2, 2), (1, 1), 128, True, False),
    ((1, 9, 7, 1024), (1, 1), (2, 2), (0, 0), 2048, True, False),
    ((1, 20, 12, 256), (3, 3), (1, 1), (1, 1), 256, False, True),
    ((1, 20, 18, 256), (3, 3), (2, 2), (1, 1), 256, False, False),
])
def test_int8_conv_kernel_matches_plain(cuda, shape, kernel, stride, pad, co,
                                        int8_in, bias):
    """QConv's int8 conv kernel: exact int32 sums and the plain version's
    dequant order, so bit-equal, for bf16 and int8 (pre-quantized) input;
    1x1, 3x3, 1x5 and 5x1, strides 1 and 2, and output sizes that leave
    ragged 16 x 8 pixel tiles. The last case's bf16 halo is too large for
    the kernel's staging buffer and is quantized through registers."""
    rng = np.random.RandomState(co + shape[1])
    args = qconv_args(rng, shape, kernel, co, int8_in, bias, cuda) + (
        stride, pad)
    before = _ext.LAUNCHES['int8_conv']
    got = Q.qconv_fused(*args)
    want = Q.qconv_reference(*args, torch.bfloat16)
    assert _ext.LAUNCHES['int8_conv'] == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


# (name, kernel, Ci -> Co, epilogue): the fused routes of Bottleneck and
# RRetinaHead
EPILOGUES = {
    'affine_relu_int8': ((1, 1), 256, 64, dict(affine=True, relu=True,
                                                out=True)),
    'affine_bf16': ((1, 1), 256, 256, dict(affine=True)),
    'affine_res_relu': ((1, 1), 64, 256, dict(affine=True, res='bf16',
                                               relu=True)),
    'affine_res8_relu': ((1, 1), 64, 256, dict(affine=True, res='int8',
                                                relu=True)),
    'relu_int8': ((3, 3), 256, 256, dict(relu=True, out=True, bias=True)),
    'relu_bf16': ((3, 3), 64, 64, dict(relu=True, bias=True)),
}


def fused_args(rng, kernel, ci, co, spec, dev, hw=(13, 11)):
    shape = (2,) + hw + (ci,)
    x, ascale, wi, ks, b = qconv_args(rng, shape, kernel, co, False,
                                      spec.get('bias', False), dev)
    kw = dict(relu=spec.get('relu', False))
    if spec.get('affine'):
        kw['affine'] = tuple(torch.from_numpy(rng.uniform(lo, hi, co).astype(
            np.float32)).to(dev, torch.bfloat16) for lo, hi in ((0.5, 2),
                                                                 (-1, 1)))
    if spec.get('res'):
        r = torch.from_numpy(rng.normal(0, 1, shape[:3] + (co,)).astype(
            np.float32)).to(dev, torch.bfloat16)
        if spec['res'] == 'int8':
            rs = r.float().abs().amax() / 127.0
            r = (Q.quantize_act(r, rs), rs)
        kw['residual'] = r
    if spec.get('out'):
        kw['out_scale'] = torch.tensor(3.0 / 127.0, device=dev)
    pad = (kernel[0] // 2, kernel[1] // 2)
    return (x, ascale, wi, ks, b, (1, 1), pad), kw


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(EPILOGUES))
def test_int8_conv_fused_epilogue_matches_plain(cuda, name):
    """The fused epilogue (FrozenBN, residual, ReLU, int8 codes for the
    next conv) repeats every rounding of the unfused ops: bit-equal, one
    launch a call."""
    kernel, ci, co, spec = EPILOGUES[name]
    args, kw = fused_args(np.random.RandomState(len(name)), kernel, ci, co,
                          spec, cuda)
    before = _ext.LAUNCHES['int8_conv']
    got = Q.qconv_fused(*args, **kw)
    assert _ext.LAUNCHES['int8_conv'] == before + 1
    want = Q.qconv_fused_reference(*args, **kw)
    if spec.get('out'):
        (got, gs), (want, ws) = got, want
        assert got.dtype == torch.int8 and gs is ws
    else:
        assert got.dtype == torch.bfloat16
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
def test_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    x = torch.zeros(1, 8, 8, 12, device=cuda)             # f32, not bf16
    k = torch.zeros(4, 4, 12, 64, device=cuda)
    s = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        K3.stem_conv_pool_cuda(x, K3.pack_stem(k, s, s))
    b = torch.zeros(1, 5, 8, device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        K1.rotated_iou_cuda(b, b)
    x, ws = bottleneck_args(np.random.RandomState(0), 32, cuda)
    with pytest.raises(ValueError):                        # F = 32
        K5.fused_bottleneck_cuda(x, *ws)
    args, kw = fused_args(np.random.RandomState(1), (1, 1), 64, 256,
                          EPILOGUES['affine_res_relu'][3], cuda)
    x, ascale, wi, ks, bias, stride, pad = args
    packed = Q.pack_weights(wi)
    bad = (
        dict(kw, residual=kw['residual'].float()),           # f32 residual
        dict(kw, residual=kw['residual'][:, :8].contiguous()),  # wrong shape
        dict(kw, affine=tuple(t.float() for t in kw['affine'])),
    )
    for b in bad:
        with pytest.raises(ValueError):
            Q.qconv_cuda(x, ascale, packed, ks, bias, stride, pad, **b)
    with pytest.raises(ValueError):                        # Co = 32
        Q.pack_weights(wi[..., :32])
    with pytest.raises(ValueError):                        # f32 input
        Q.qconv_cuda(x.float(), ascale, packed, ks, bias, stride, pad, **kw)
    with kernels(False), pytest.raises(ValueError):       # switched off
        Q.qconv_cuda(x, ascale, packed, ks, bias, stride, pad, **kw)


# ---------------------------------------------------------------------------
# K2's backward (dfeat = g + S^T g) and the train step on the card
# ---------------------------------------------------------------------------

def bf16_ulp(v):
    """One bf16 ulp at |v| (f32 tensor; 0 at 0)."""
    m, e = torch.frexp(v)
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), e - 8))


def frm_bwd_error(got, grads, rois, scales, points, quirk):
    """K2's backward against its plain backward computed in f32 and
    rounded to bf16. Bound a value: one bf16 ulp of the f32 reference plus
    2^-14 of the sum of the absolute contributions A (|g| + sum |w g|,
    the plain backward of |g|): the kernel's ordered sums and the plain
    scatter sum the same f32 products in other orders, whose f32 roundings differ
    by well under 2^-14 A for sums of a few thousand terms. Returns (the
    largest excess over the bound, max |kernel - f32 reference|, max
    |kernel - bf16 plain backward|)."""
    ref32 = K2.frm_sample_levels_bwd_reference(
        [g.float() for g in grads], rois, scales, points, quirk)
    absum = K2.frm_sample_levels_bwd_reference(
        [g.float().abs() for g in grads], rois, scales, points, quirk)
    plain = K2.frm_sample_levels_bwd_reference(grads, rois, scales, points,
                                               quirk)
    excess, err, gap = -math.inf, 0.0, 0.0
    for k, r, a, p in zip(got, ref32, absum, plain):
        assert k.dtype == torch.bfloat16 and k.shape == r.shape
        d = (k.float() - r.to(torch.bfloat16).float()).abs()
        slack = 2.0 ** -14 * a
        tol = bf16_ulp(r.abs() + slack) + slack
        excess = max(excess, float((d - tol).max()))
        err = max(err, float((k.float() - r).abs().max()))
        gap = max(gap, float((k.float() - p.float()).abs().max()))
    return excess, err, gap


def colliding_rois(rng, b, sizes, target=(0.3, 0.6)):
    """Rois that send every cell's centre to one point near a fixed
    corner of each level (transposed quirk: row <- cx, col <- cy), and a
    few to the map's clamped edge: every cell scatters onto the same four
    corners."""
    rois = []
    for (h, w), stride in zip(sizes, (8, 16, 32, 64, 128)):
        n = h * w
        cx = np.full((b, n), target[0] * h * stride)
        cy = np.full((b, n), target[1] * w * stride)
        edge = rng.uniform(size=(b, n)) < 0.1
        cx[edge] = (h - 0.5) * stride                  # clamped to h - 1
        rois.append(np.stack([cx, cy, rng.uniform(8, 64, (b, n)),
                              rng.uniform(8, 64, (b, n)),
                              rng.uniform(-1.5, 1.5, (b, n))], -1)
                    .astype(np.float32))
    return rois


FRM_BWD_CASES = {
    'main': (FRM_CASES['main'][0], 256, 2, False),
    'ragged': (FRM_CASES['ragged'][0], 264, 2, False),
    'collide': (FRM_CASES['main'][0], 256, 2, True),
    'batch1': (FRM_CASES['ragged'][0], 256, 1, False),
    'batch3': (((24, 40), (12, 20), (6, 10), (3, 5), (2, 3)), 64, 3, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
@pytest.mark.parametrize('case', list(FRM_BWD_CASES))
def test_frm_sample_bwd_kernel_matches_f32_plain(cuda, case, points, quirk):
    """K2's backward, all levels in one launch: within a bf16 ulp of the
    f32 plain backward (frm_bwd_error), on the main-path levels, ragged
    maps, edge and outside rois (frm_levels), a roi set where every cell
    lands on one corner, points 1 and 5, batch 1 to 3."""
    sizes, c, b, collide = FRM_BWD_CASES[case]
    rng = np.random.RandomState(11 + points + 2 * quirk)
    xs, feats, rois, scales = frm_levels(rng, b, sizes, c, cuda)
    if collide:
        rois = [torch.from_numpy(r).to(cuda)
                for r in colliding_rois(rng, b, sizes)]
    grads = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32)).to(
        cuda, torch.bfloat16) for f in feats]
    before = _ext.LAUNCHES['frm_sample_bwd']
    got = K2.frm_sample_levels_bwd_cuda(grads, rois, scales, points, quirk)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['frm_sample_bwd'] == before + 1
    excess, err, gap = frm_bwd_error(got, grads, rois, scales, points, quirk)
    print(f'{case} points={points} quirk={quirk}: max|k - f32 ref| {err} '
          f'max|k - bf16 plain| {gap} excess {excess}')
    assert excess <= 0.0, (err, gap)


def clustered_rois(rng, b, sizes, objects=12):
    """Rois whose centres sit on a few object centres a level, as a trained
    model's best boxes do (every cell of an object points at its centre):
    corner rows of tens to thousands of contributions."""
    rois = []
    for (h, w), stride in zip(sizes, (8, 16, 32, 64, 128)):
        n = h * w
        centres = rng.uniform(0, 1, (b, objects, 2)) * (h * stride,
                                                        w * stride)
        pick = rng.randint(0, objects, (b, n))
        cxy = np.take_along_axis(centres, pick[..., None], 1)
        rois.append(np.concatenate([
            cxy, rng.uniform(8, 256, (b, n, 2)),
            rng.uniform(-1.6, 1.6, (b, n, 1))], -1).astype(np.float32))
    return rois


def frm_bwd_inputs(rng, case, cuda):
    """(grads, rois, scales) of one FRM_BWD_CASES case or 'clusters' (the
    main-path levels with clustered_rois); a tenth of the gradient values
    are -0.0, which a corner row that no point reads returns as +0.0."""
    sizes, c, b, rule = FRM_BWD_CASES.get(
        case, (FRM_CASES['main'][0], 256, 2, False))
    _, feats, rois, scales = frm_levels(rng, b, sizes, c, cuda)
    if rule:
        rois = colliding_rois(rng, b, sizes)
    elif case == 'clusters':
        rois = clustered_rois(rng, b, sizes)
    rois = [r if torch.is_tensor(r) else torch.from_numpy(r).to(cuda)
            for r in rois]
    grads = []
    for f in feats:
        g = rng.randn(*f.shape).astype(np.float32)
        g[rng.uniform(size=g.shape) < 0.1] = -0.0
        grads.append(torch.from_numpy(g).to(cuda, torch.bfloat16))
    return grads, rois, scales


def bits(t):
    return t.view(torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
@pytest.mark.parametrize('case', list(FRM_BWD_CASES) + ['clusters'])
def test_frm_sample_bwd_kernel_equals_ordered_plain(cuda, case, points,
                                                     quirk):
    """K2's backward, one launch for all levels, bit for bit equal to its
    ordered plain form (frm_sample_levels_bwd_ordered on CPU copies of the
    same inputs and of the card's cos/sin): the main-path levels, ragged
    maps and C = 264, batch 1 and 3, every cell on one corner (rows of
    thousands of contributions, summed in chunks), and clustered rois."""
    rng = np.random.RandomState(31 + points + 2 * quirk)
    grads, rois, scales = frm_bwd_inputs(rng, case, cuda)
    trig = K2.angle_trig(rois) if points == 5 else None
    before = _ext.LAUNCHES['frm_sample_bwd']
    got = K2.frm_sample_levels_bwd_cuda(grads, rois, scales, points, quirk,
                                        trig)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['frm_sample_bwd'] == before + 1
    want = K2.frm_sample_levels_bwd_ordered(
        [g.cpu() for g in grads], [r.cpu() for r in rois], scales, points,
        quirk, None if trig is None else trig.cpu())
    for lvl, (k, w) in enumerate(zip(got, want)):
        k = k.cpu()
        assert k.dtype == w.dtype and k.shape == w.shape
        assert torch.equal(bits(k), bits(w)), (
            lvl, int((bits(k) != bits(w)).sum()),
            float((k.float() - w.float()).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize('points', [1, 5])
@pytest.mark.parametrize('case', ['main', 'collide', 'clusters'])
def test_frm_sample_bwd_kernel_is_deterministic(cuda, case, points):
    """Three launches on the same inputs give the same bits."""
    rng = np.random.RandomState(41 + points)
    grads, rois, scales = frm_bwd_inputs(rng, case, cuda)
    runs = [K2.frm_sample_levels_bwd_cuda(grads, rois, scales, points)
            for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(bits(a), bits(b))


@pytest.mark.gpu
@pytest.mark.parametrize('points', [1, 5])
def test_frm_sample_function_wiring(cuda, points):
    """FRMSampleLevels under autograd: one forward and one backward launch;
    dx is the output gradient itself, dfeat K2's backward; and the adjoint
    identity <dfeat, v> = <g, d out / d feat . v> against the plain f32
    forward's linear map (a gradcheck of the wiring, in bf16's precision)."""
    sizes, c = FRM_CASES['ragged']
    rng = np.random.RandomState(20 + points)
    xs, feats, rois, scales = frm_levels(rng, 2, sizes, c, cuda)
    xs = [x.requires_grad_() for x in xs]
    feats = [f.requires_grad_() for f in feats]
    fwd = _ext.LAUNCHES['frm_sample']
    bwd = _ext.LAUNCHES['frm_sample_bwd']
    outs = K2.frm_sample_levels(xs, feats, rois, scales, points)
    assert all(o.grad_fn is not None for o in outs)
    grads = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(
        cuda, torch.bfloat16) for o in outs]
    torch.autograd.backward(outs, grads)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['frm_sample'] == fwd + 1
    assert _ext.LAUNCHES['frm_sample_bwd'] == bwd + 1
    for x, g in zip(xs, grads):
        assert torch.equal(x.grad, g)
    excess, _, _ = frm_bwd_error([f.grad for f in feats], grads, rois,
                                 scales, points, True)
    assert excess <= 0.0
    # adjoint: <dfeat, v> against <g, v + S v> from the f32 plain forward.
    # dfeat is rounded to bf16 (at most 2^-9 of each value): those errors
    # are independent, so their sum stays within a few root-sum-squares of
    # 2^-9 |dfeat_i v_i|; a missing or doubled term of the transpose moves
    # it by hundreds of them
    vs = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32)).to(cuda)
          for f in feats]
    with torch.no_grad():
        lin = K2.frm_sample_levels_reference(
            [torch.zeros_like(v) for v in vs], vs, rois, scales, points)
    terms = [f.grad.double() * v.double() for f, v in zip(feats, vs)]
    lhs = sum(float(t.sum()) for t in terms)
    rhs = sum(float((g.double() * o.double()).sum())
              for g, o in zip(grads, lin))
    rss = math.sqrt(sum(float(t.square().sum()) for t in terms))
    assert abs(lhs - rhs) <= 8 * 2.0 ** -9 * rss, (lhs, rhs, rss)


@pytest.mark.gpu
def test_frm_sample_bwd_wrapper_checks(cuda):
    x = torch.zeros(2, 8, 8, 256, device=cuda, dtype=torch.bfloat16)
    rois = torch.zeros(2, 64, 5, device=cuda)
    for g in (x.float(), x[..., :12].contiguous(), misaligned(x)):
        with pytest.raises(ValueError):
            K2.frm_sample_levels_bwd_cuda([g], [rois], [0.125])
    with pytest.raises(ValueError):
        K2.frm_sample_levels_bwd_cuda([x], [rois], [0.125], points=3)
    with pytest.raises(ValueError):
        K2.frm_sample_levels_bwd_cuda([x.cpu()], [rois.cpu()], [0.125])


def tiny_train_setup(dev, frm_points=1):
    """A small bf16 R3Det on the card (depth 10, width 32, one tower conv,
    3 classes) with seeded weights, and a seeded batch of two 64^2
    images, as a dict of card tensors."""
    from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
    from r3det_tpu_torch.models.detectors import StageTrainCfg
    cfg = DetectorConfig(
        num_classes=3, stacked_convs=1, feat_channels=32, backbone_depth=10,
        num_refine_stages=1, stage_loss_weights=(1.0,),
        s0_train=StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
        sr_train=(StageTrainCfg(0.6, 0.5, 0.0, None),),
        test=TestCfg(nms_pre=64, max_per_img=16))
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev,
                           frm_points=frm_points)
    model.load_state_dict(seeded_state_dict(model, 0))
    data = SyntheticDetData(batch_size=2, size=64, max_gt=8, num_classes=3,
                            seed=0).batch()
    data['gt_bboxes'][..., :2] = np.clip(data['gt_bboxes'][..., :2], 8, 56)
    data['gt_bboxes'][..., 2:4] /= 3
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return cfg, model, batch


def grad_rel_err(a, b):
    """Relative L2 error of gradient lists a against b (None as zero):
    over all parameters at once, and the worst parameter's among those
    whose gradient is not zero."""
    pairs = [(x, y) for x, y in zip(a, b) if x is not None or y is not None]
    a = [x.float() if x is not None else torch.zeros_like(y, dtype=torch.float)
         for x, y in pairs]
    b = [y.float() if y is not None else torch.zeros_like(a[i])
         for i, (_, y) in enumerate(pairs)]
    num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.square().sum()) for y in b)
    worst = max(float((x - y).norm() / y.norm()) for x, y in zip(a, b)
                if float(y.norm()) > 0)
    return math.sqrt(num / den), worst


@pytest.mark.gpu
def test_train_step_kernel_route_matches_plain(cuda):
    """One bf16 train step of a small R3Det on the card: the kernel route
    (K3 forward, K1 in the refine assignment, K2 forward and backward, one
    launch each) against the plain route (use_kernels False) on the same
    weights and batch. Losses within 2% (bf16 forwards that round a few
    stem values apart); gradients within 5% relative L2 over all
    parameters (the plain bf16 backward of the sample also sums its
    scatter in bf16)."""
    from r3det_tpu_torch.parallel.train import loss_and_grads
    cfg, model, batch = tiny_train_setup(cuda)
    sizes = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
    _ext.reset_launches()
    losses, grads = loss_and_grads(model, cfg, sizes, batch)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    assert {k: launches[k] for k in ('rotated_iou', 'frm_sample',
                                     'frm_sample_bwd', 'stem_conv_pool')} \
        == dict(rotated_iou=1, frm_sample=1, frm_sample_bwd=1,
                stem_conv_pool=1), launches
    use_kernels(model, False)
    try:
        plain_losses, plain_grads = loss_and_grads(model, cfg, sizes, batch)
    finally:
        use_kernels(model, True)
    for k, v in plain_losses.items():
        assert torch.isfinite(losses[k]), k
        assert abs(float(losses[k]) - float(v)) <= 0.02 * abs(float(v)), k
    total, worst = grad_rel_err(grads, plain_grads)
    print(f'grad rel L2: all {total}, worst parameter {worst}')
    assert total <= 0.05
    # the frozen stem and stage 1 get none
    names = [n for n, _ in model.named_parameters()]
    for n, g in zip(names, grads):
        if n.startswith(('backbone.conv1', 'backbone.bn1',
                         'backbone.layer1_')):
            assert g is None, n


@pytest.mark.gpu
@pytest.mark.parametrize('hw,scale', [((512, 512), (1024, 1024)),
                                      ((700, 333), (1024, 1024)),
                                      ((64, 64), (32, 32)),
                                      ((3, 2), (800, 800))])
def test_eval_transforms_on_card_equal_cpu(cuda, hw, scale):
    """RResize (cv2's INTER_LINEAR in integers), Normalize and Pad on the
    card equal their CPU result bit for bit."""
    from r3det_tpu_torch.datasets.transforms import Normalize, Pad, RResize
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,), np.uint8)
    canvas = tuple(-(-d // 32) * 32 for d in scale[::-1])
    outs = []
    for dev in ('cpu', cuda):
        r = dict(img=torch.from_numpy(img).to(dev))
        for stage in (RResize(scale), Normalize(), Pad(32, fixed_size=canvas)):
            r = stage(r)
        outs.append(r)
    assert outs[1]['img'].device.type == 'cuda'
    assert torch.equal(outs[0]['img'], outs[1]['img'].cpu())
    assert outs[0]['img_shape'] == outs[1]['img_shape']
    np.testing.assert_array_equal(outs[0]['scale_factor'],
                                  outs[1]['scale_factor'])


def _found(a, b):
    """Fraction of run a's detections (per image, per class) found in run
    b: same class, box and score within 1e-2 relative."""
    found = total = 0
    for ra, rb in zip(a, b):
        for xa, xb in zip(ra, rb):
            total += len(xa)
            if len(xa) and len(xb):
                d = np.abs(xa[:, None] - xb[None])
                found += int((d <= 1e-2 * (np.abs(xa[:, None]) + 1)).all(-1)
                             .any(1).sum())
    return found / max(total, 1)


@pytest.mark.gpu
def test_evaluate_dataset_kernel_route_matches_plain(cuda, tmp_path):
    """The eval loop on a small bf16 R3Det over a fake-DOTA split at 256^2:
    K1, K2 and K3 once a predict step; its detections found in the plain
    route's (use_kernels False) and back at 0.75 or more."""
    from r3det_tpu_torch.datasets.dota import DOTADataset
    from r3det_tpu_torch.tools import make_fake_dota
    from r3det_tpu_torch.utils.eval_loop import evaluate_dataset
    split = str(tmp_path / 'split')
    make_fake_dota.main(['--out', str(tmp_path / 'raw'), '--split-out',
                         split, '--num-images', '1'])
    ds = DOTADataset(split + '/annfiles/', split + '/images/',
                     filter_empty=False, classes=make_fake_dota.CLASSES)
    cfg = DetectorConfig(num_classes=3, stacked_convs=2, feat_channels=32,
                         backbone_depth=10, num_refine_stages=1,
                         test=TestCfg(nms_pre=64, max_per_img=16))
    model = build_detector(cfg, dtype=torch.bfloat16, device=cuda)
    model.load_state_dict(seeded_state_dict(model, 0))
    with torch.no_grad():
        model.refine_head_0.retina_cls.bias.zero_()   # every score live
    _ext.reset_launches()
    got = evaluate_dataset(model, cfg, ds, img_size=256, batch_size=2)
    torch.cuda.synchronize()
    steps = -(-len(ds) // 2)
    assert {k: _ext.LAUNCHES[k] for k in ('rotated_iou', 'nms_sweep',
                                          'frm_sample', 'stem_conv_pool')} \
        == dict(rotated_iou=steps, nms_sweep=steps, frm_sample=steps,
                stem_conv_pool=steps)
    use_kernels(model, False)
    try:
        plain = evaluate_dataset(model, cfg, ds, img_size=256, batch_size=2)
    finally:
        use_kernels(model, True)
    assert all(sum(len(c) for c in r) > 0 for r in got)
    assert min(_found(got, plain), _found(plain, got)) >= 0.75


@pytest.mark.gpu
@pytest.mark.parametrize('hw,angle,dsize', [
    ((1024, 1024), 37.5, (1024, 1024)), ((700, 333), -121.0, (718, 372)),
    ((513, 1000), 90, (1000, 513)), ((31, 17), 180, (40, 25))])
def test_warp_affine_on_card_equals_cpu(cuda, hw, angle, dsize):
    """The train pipeline's warpAffine (float32 with fused multiply-adds
    done in float64, held to cv2 on the CPU) gives the CPU's result on
    the card, bit for bit."""
    from r3det_tpu_torch.datasets.transforms import (get_rotation_matrix_2d,
                                                     warp_affine_linear)
    img = np.random.RandomState(hw[1]).randint(0, 256, hw + (3,), np.uint8)
    m = get_rotation_matrix_2d((hw[1] / 2 - 0.5, hw[0] / 2 - 0.5), angle, 1)
    want = warp_affine_linear(torch.from_numpy(img), m, dsize)
    got = warp_affine_linear(torch.from_numpy(img).to(cuda), m, dsize)
    assert got.device.type == 'cuda'
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_train_loader_on_card_equals_cpu(cuda, tmp_path):
    """DetLoader + TrainPipeline (RResize, flip, PolyRandomRotate v3,
    Normalize, Pad) over a fake-DOTA split: the card's batches equal the
    CPU's, images bit for bit, boxes exactly."""
    from r3det_tpu_torch.datasets.dota import DOTADataset
    from r3det_tpu_torch.datasets.loader import DetLoader
    from r3det_tpu_torch.datasets.transforms import TrainPipeline
    from r3det_tpu_torch.tools import make_fake_dota
    split = str(tmp_path / 'split')
    make_fake_dota.main(['--out', str(tmp_path / 'raw'), '--split-out',
                         split, '--num-images', '1'])
    ds = DOTADataset(split + '/annfiles/', split + '/images/', version='v3',
                     classes=make_fake_dota.CLASSES)
    runs = []
    for dev in ('cpu', cuda):
        pipe = TrainPipeline((1024, 1024), version='v3', with_rotate=True,
                             rotate_kwargs=dict(rotate_ratio=1.0), max_gt=32,
                             seed=4, device=dev)
        pipe.pad_to(1024, 1024)
        runs.append([{k: v.cpu() for k, v in b.items()} for b in DetLoader(
            ds, pipe, batch_size=2, seed=1, num_workers=2, device=dev)])
    assert len(runs[0]) == len(runs[1]) > 0
    for a, b in zip(*runs):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_ddp_step_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks of the data-parallel train step sharing the card over
    gloo (chip_smoke's [ddp_step] on a small R3Det at 256^2, a global
    batch of 4), against one process stepping the whole batch: losses
    within 2%, parameters within 5% of the update (relative L2), the
    ranks bit-identical after every step, K1, K2, K2's backward and K3
    once a step on each rank (all checked inside ``ddp_step``)."""
    import chip_smoke
    small = dict(backbone_depth=10, feat_channels=32, stacked_convs=1)
    ref = chip_smoke.ddp_reference(cuda, small, size=256, batch=4)
    rec = chip_smoke.ddp_step(2, 'gloo', [cuda.index, cuda.index], ref,
                              str(tmp_path), small, size=256, batch=4)
    assert rec['same'] and len(rec['losses']) == chip_smoke.DDP_STEPS


# kernel_bench's subcommands at batch 1: every int8 parity exact, the bf16
# ones within chip_smoke's card tolerances (K3 one ulp, K5 0.03125, K2, K4
# and the conv epilogue exact), every variant timed with its bound
@pytest.mark.gpu
@pytest.mark.parametrize('which', ['stem', 'bottleneck', 'frm', 'swin'])
def test_kernel_bench_parities(cuda, which):
    from r3det_tpu_torch.tools import kernel_bench
    res = kernel_bench.RUNS[which](batch=1)
    par = res['parity']
    if which == 'stem':
        assert par['K3 int8 vs plain int8 (b1)'] == 0.0
        assert par['plain conv + K4 vs plain (b1)'] == 0.0
        assert res['ulps']['K3 bf16 vs plain (b1)'] <= 1.0
        timed = res['ms']
    elif which == 'bottleneck':
        for tag in ('C2', 'C3'):
            assert par[f'{tag} K5 q8 vs plain int8 (b1)'] == 0.0
            assert par[f'{tag} K5 vs plain (b1, bf16)'] <= 0.03125
        assert par['C2 conv epilogue vs unfused (b1)'] == 0.0
        timed = {f'{t}/{k}': v for t, r in res['ms'].items()
                 for k, v in r.items()}
        assert len(timed) == 8
        assert len(res['epilogue']) == 4
        timed.update(res['epilogue'])
    elif which == 'swin':
        # one bf16 ulp of LN outputs of about 4 at most, and P's rounding
        # on unit-normal v (the kernel tests' tolerances)
        assert len(par) == 8 and max(par.values()) <= 2 ** -5, par
        timed = {f'{t}/{k}': v for t, r in res['ms'].items()
                 for k, v in r.items()}
        assert len(timed) == 4 * 7
    else:
        assert par['K2 vs plain gather (b1)'] == 0.0
        timed = res['ms']
    for name, t in timed.items():
        assert t['ms'] > 0, name
        if 'sub-block' in name:         # timed without a bound of its own
            assert 'bound_ms' not in t, name
            continue
        assert t['bound_ms'] > 0, name
        assert t['bound_by'] in ('bytes', 'operations'), name


# ---------------------------------------------------------------------------
# The bf16 conv epilogue (csrc/conv_epilogue.cu) and the bottleneck's route
# through it
# ---------------------------------------------------------------------------

def same_bits(got, want):
    """Equal bit for bit, NaN where NaN (any NaN payload)."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(g[~nan], w[~nan])


def special_bf16(rng, shape, dev):
    """A channels_last bf16 tensor of normal values with NaN, +-inf, +-0.0
    and values that overflow once scaled, at random places."""
    x = rng.normal(0, 1, shape).astype(np.float32)
    pick = rng.randint(0, 12, shape)
    for code, v in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0, 3e38,
                              -3e38)):
        x[pick == code] = v
    return torch.from_numpy(x).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def special_affine(rng, c, dev):
    """(inv, b) bf16 with zero, huge and negative scales and -0.0 offsets
    beside ordinary ones."""
    inv = rng.normal(0, 1, c).astype(np.float32)
    b = rng.normal(0, 1, c).astype(np.float32)
    inv[0], inv[1], b[2:4] = 0.0, 3e38, -0.0
    return tuple(torch.from_numpy(v).to(dev, torch.bfloat16)
                 for v in (inv, b))


@pytest.mark.gpu
@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'no_relu'])
@pytest.mark.parametrize('variant', ['affine', 'identity', 'downsample'])
@pytest.mark.parametrize('shape', [(2, 64, 13, 17), (1, 2048, 7, 5)])
def test_conv_epilogue_kernel_special_values(cuda, shape, variant, relu):
    """The kernel against its plain form on the card, bit for bit, with
    NaN, +-inf, +-0.0 and overflow; ragged pixel counts, C 64 and 2048;
    one launch a call, in place."""
    rng = np.random.RandomState(shape[1] + len(variant))
    a, r, d = (special_bf16(rng, shape, cuda) for _ in range(3))
    inv, b = special_affine(rng, shape[1], cuda)
    residual = {'affine': None, 'identity': r,
                'downsample': (d, *special_affine(rng, shape[1], cuda))}[
                    variant]
    want = E.conv_epilogue_reference(a, inv, b, residual, relu)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    before = _ext.LAUNCHES['conv_epilogue']
    a_in = a.clone()
    got = E.conv_epilogue_cuda(a_in, inv, b, residual, relu)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['conv_epilogue'] == before + 1
    assert got.data_ptr() == a_in.data_ptr()
    same_bits(got, want)


def seeded_resnet50(dev, seed):
    """A bf16 ResNet-50 with seeded conv weights and FrozenBNs away from
    the identity."""
    net = ResNet(depth=50, dtype=torch.bfloat16)
    net.load_state_dict(seeded_state_dict(net, seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBN):
                c = m.scale.numel()
                for t, v in ((m.scale, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.mean, rng.normal(0, 0.1, c)),
                             (m.var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return net.to(dev)


def r50_blocks(net):
    return [(f'layer{s + 1}_{i}', getattr(net, f'layer{s + 1}_{i}'))
            for s, n in enumerate(STAGE_BLOCKS[50]) for i in range(n)]


def r50_images(dev, batch=2, size=1024):
    gen = torch.Generator(dev).manual_seed(0)
    return torch.rand(batch, size, size, 3, generator=gen, device=dev) * 4 - 2


@pytest.mark.gpu
def test_conv_epilogue_kernel_on_r50_block_shapes(cuda):
    """Every conv epilogue of a ResNet-50 at batch 2 of 1024^2 (16 blocks,
    three each, the four downsample residuals among them), on the blocks'
    own conv outputs: the kernel equals its plain form bit for bit."""
    net = seeded_resnet50(cuda, 0)
    inputs = {}
    hooks = [blk.register_forward_pre_hook(
        lambda m, a, n=n: inputs.__setitem__(n, a[0]))
        for n, blk in r50_blocks(net)]
    try:
        with torch.no_grad():
            net(r50_images(cuda))
    finally:
        for h in hooks:
            h.remove()
    bf16, calls = torch.bfloat16, 0
    with torch.no_grad():
        for name, blk in r50_blocks(net):
            x = inputs.pop(name)
            y = None
            for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2),
                             (blk.conv3, blk.bn3)):
                a = conv(x if y is None else y)
                residual = None
                if bn is blk.bn3:
                    residual = (blk.downsample_conv(x),
                                *blk.downsample_bn.affine(bf16)) \
                        if blk.has_downsample else x
                y = E.conv_epilogue_reference(a, *bn.affine(bf16), residual)
                got = E.conv_epilogue_cuda(a.clone(), *bn.affine(bf16),
                                           residual)
                same_bits(got, y)
                calls += 1
    assert calls == 48


@pytest.mark.gpu
def test_resnet50_epilogue_route_equals_unfused(cuda, monkeypatch):
    """A whole bf16 ResNet-50 on the card (batch 2, 1024^2): the epilogue
    route, 48 launches, equals the unfused route bit for bit at C2-C5.
    Under autograd only the frozen stage (C2, run with gradients off)
    takes it."""
    net = seeded_resnet50(cuda, 1)
    images = r50_images(cuda)
    _ext.reset_launches()
    with torch.no_grad():
        got = net(images)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES['conv_epilogue'] == 48
    monkeypatch.setattr(Bottleneck, 'epilogue_route', lambda self, x: False)
    with torch.no_grad():
        want = net(images)
    monkeypatch.undo()
    for g, w in zip(got, want):
        same_bits(g, w)
    _ext.reset_launches()
    net(images[:1, :256, :256].contiguous())
    assert _ext.LAUNCHES['conv_epilogue'] == 3 * STAGE_BLOCKS[50][0]


@pytest.mark.gpu
def test_predict_step_epilogue_spans(cuda):
    """A bf16 R3Det R50 predict step records 48 ``r3det.backbone.epilogue``
    ranges with the spans on, and none with kernels off."""
    cfg = R3DET_R50_V1
    model = build_detector(cfg, dtype=torch.bfloat16, device=cuda)
    model.load_state_dict(seeded_state_dict(model, 0))
    size = 256
    sizes = tuple((size // s, size // s) for s in cfg.strides)
    step = make_predict_step(model, cfg, sizes, img_shape=(size, size))
    images = r50_images(cuda, 1, size)

    def count():
        _, spans = traced(lambda: step(images))
        torch.cuda.synchronize()
        return sum(n == 'r3det.backbone.epilogue' for n, _, _ in spans)
    assert count() == 48
    use_kernels(model, False)
    try:
        assert count() == 0
    finally:
        use_kernels(model, True)


@pytest.mark.gpu
def test_conv_epilogue_wrapper_raises(cuda):
    rng = np.random.RandomState(0)
    a = special_bf16(rng, (1, 64, 4, 4), cuda)
    inv, b = special_affine(rng, 64, cuda)
    bad = [
        (special_bf16(rng, (1, 72, 4, 4), cuda), inv, b, None),   # C = 72
        (a.float(), inv, b, None),                                # f32
        (a.contiguous(), inv, b, None),                           # NCHW
        (a, inv[:32], b, None),                                   # (32,)
        (a, inv, b, a[:, :, :2]),                                 # residual
        (a, inv, b, (a, inv.float(), b)),                         # f32 inv_d
    ]
    for args in bad:
        with pytest.raises(ValueError):
            E.conv_epilogue_cuda(*args)


# The Swin-T backbone (models/swin.py) in bf16 on the card against the
# benchmark's float32 reference (portbench/reference/backbones/swin.py)

def swin_pair(dev, seed=7):
    """The port's bf16 rotated RetinaNet Swin-T and the float32 reference
    detector on one seeded state, from the benchmark's configuration."""
    import json
    from pathlib import Path

    from portbench.bench import common
    from portbench.reference.model import Detector
    root = Path(__file__).resolve().parent.parent / 'portbench'
    cfg = json.loads((root / 'configs' / 'rretinanet_obb_swin_t.json')
                     .read_text())
    ref = Detector(cfg).to(dev)
    state = common.seeded_state(ref, seed, dev)
    ref.load_state_dict(state)
    model = build_detector(common.program_config(cfg),
                           dtype=torch.bfloat16, device=dev)
    model.load_state_dict(state)
    return model, ref


@pytest.mark.gpu
def test_swin_t_bf16_matches_the_float32_reference(cuda):
    """Published widths, one 224^2 image: each output within 3% (relative
    norm) of the reference. bf16 stores each activation to 2^-9, and the
    residual stream of 12 blocks carries it (the cell's ``err.fpn`` of
    the whole FPN reads about 1%); the reference computed in fp8 misses
    the same bound."""
    from portbench.bench import check
    model, ref = swin_pair(cuda)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.rand(1, 224, 224, 3, generator=g, device=cuda) * 4 - 2
    with torch.no_grad():
        got = model.backbone(x)
        want = ref.backbone(x)
        low = check.quantized(ref.backbone, 'fp8', x)
    assert [tuple(t.shape) for t in got] == [(1, 192, 28, 28),
                                             (1, 384, 14, 14), (1, 768, 7, 7)]
    assert all(t.dtype == torch.bfloat16 for t in got)
    for a, b, c in zip(got, want, low):
        assert check.rel_err([a], [b]) < 0.03
        assert check.rel_err([c], [b]) > 0.03


@pytest.mark.gpu
def test_swin_t_spans_and_no_host_round_trip(cuda):
    """With the spans on, a forward records 1 embed, 12 attn, 12 mlp and 3
    merge ranges and no copy or sync range; once the bias and mask are
    made, it makes no host-to-device copy and no synchronising call."""
    from torch.profiler import ProfilerActivity, profile
    model, _ = swin_pair(cuda)
    x = torch.rand(2, 224, 224, 3, device=cuda)
    with torch.no_grad():
        model.backbone(x)                        # the bias and mask, once
        _, spans = traced(lambda: model.backbone(x))
        names = [n for n, _, _ in spans]
        assert {n: names.count(n) for n in set(names)} == {
            'r3det.backbone.swin.embed': 1, 'r3det.backbone.swin.attn': 12,
            'r3det.backbone.swin.mlp': 12, 'r3det.backbone.swin.merge': 3}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode('error')
            try:
                model.backbone(x)
            finally:
                torch.cuda.set_sync_debug_mode('default')
            torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if 'HtoD' in e.name]
    assert copies == []



# The LSKNet-S backbone (models/lsknet.py) in bf16 on the card against its
# own float32 plain route and the benchmark's float32 reference
# (portbench/reference/backbones/lsknet.py)

def lsknet_models(dev, seed=7):
    """The port's rotated RetinaNet LSKNet-S in bf16 and in float32, and
    the float32 reference detector, on one seeded state, from the
    benchmark's configuration."""
    import json
    from pathlib import Path

    from portbench.bench import common
    from portbench.reference.model import Detector
    root = Path(__file__).resolve().parent.parent / 'portbench'
    cfg = json.loads((root / 'configs' / 'rretinanet_obb_lsknet_s.json')
                     .read_text())
    ref = Detector(cfg).to(dev)
    state = common.seeded_state(ref, seed, dev)
    ref.load_state_dict(state)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        model = build_detector(common.program_config(cfg), dtype=dtype,
                               device=dev)
        model.load_state_dict(state)
        out.append(model)
    return out[0], out[1], ref


@pytest.mark.gpu
def test_lsknet_s_bf16_matches_the_float32_plain_route(cuda):
    """Published widths, one 512^2 image: each stage's output within 3%
    (relative norm) of the same port in float32 (TF32 off). bf16 stores
    each activation to 2^-9, and the residual stream of a stage carries
    it through up to four blocks whose gate multiplies two rounded
    branches (the CPU reads 0.6-1.5% a stage at 256^2, stage 3 the
    largest); the reference computed in fp8 reads 5.6-17% and misses the
    bound."""
    from portbench.bench import check
    model, plain, ref = lsknet_models(cuda)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.rand(1, 512, 512, 3, generator=g, device=cuda) * 4 - 2
    with torch.no_grad():
        got = model.backbone(x)
        want = plain.backbone(x)
        low = check.quantized(ref.backbone, 'fp8', x)
    assert [tuple(t.shape) for t in got] == [
        (1, 64, 128, 128), (1, 128, 64, 64), (1, 320, 32, 32),
        (1, 512, 16, 16)]
    assert all(t.dtype == torch.bfloat16 and
               t.is_contiguous(memory_format=torch.channels_last)
               for t in got)
    for a, b, c in zip(got, want, low):
        assert b.dtype == torch.float32
        assert check.rel_err([a], [b]) < 0.03
        assert check.rel_err([c], [b]) > 0.03


@pytest.mark.gpu
def test_lsknet_s_spans_and_no_host_round_trip(cuda):
    """With the spans on, a forward records 4 embed, 10 attn, 10 mlp and 4
    norm ranges and no copy or sync range; once the BN affines are folded,
    it makes no host-to-device copy and no synchronising call."""
    from torch.profiler import ProfilerActivity, profile
    model, _, _ = lsknet_models(cuda)
    x = torch.rand(2, 256, 256, 3, device=cuda)
    with torch.no_grad():
        model.backbone(x)                        # the BN affines, once
        _, spans = traced(lambda: model.backbone(x))
        names = [n for n, _, _ in spans]
        assert {n: names.count(n) for n in set(names)} == {
            'r3det.backbone.lsk.embed': 4, 'r3det.backbone.lsk.attn': 10,
            'r3det.backbone.lsk.mlp': 10, 'r3det.backbone.lsk.norm': 4}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode('error')
            try:
                model.backbone(x)
            finally:
                torch.cuda.set_sync_debug_mode('default')
            torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if 'HtoD' in e.name]
    assert copies == []


# ViTDet's ViT-B backbone (models/vitdet.py, plain PyTorch) in bf16 on the
# card against the same module in float32, and the benchmark's float32
# reference computed in fp8 (portbench/reference/backbones/vitdet.py)

# bf16 ViT-B against the float32 port at batch 2 of 1024^2: 0.98-1.18% a
# level; the float32 reference with every linear and conv in fp8: 9.1-10.3%
# (H100). 3% leaves room on both sides.
VIT_BF16_BOUND = 0.03


def vitdet_models(dev, seed=7):
    """The port's rotated RetinaNet ViT-B in bf16 and in float32, and the
    float32 reference detector, on one seeded state, from the benchmark's
    configuration."""
    import json
    from pathlib import Path

    from portbench.bench import common
    from portbench.reference.model import Detector
    root = Path(__file__).resolve().parent.parent / 'portbench'
    cfg = json.loads((root / 'configs' / 'rretinanet_obb_vitdet_b.json')
                     .read_text())
    ref = Detector(cfg).to(dev)
    state = common.seeded_state(ref, seed, dev)
    ref.load_state_dict(state)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        model = build_detector(common.program_config(cfg), dtype=dtype,
                               device=dev)
        model.load_state_dict(state)
        out.append(model)
    return out[0], out[1], ref


@pytest.mark.gpu
def test_vitdet_b_bf16_matches_the_float32_port(cuda):
    """Published widths, batch 2 of 1024^2: each pyramid level within
    VIT_BF16_BOUND (relative norm) of the same port in float32 (TF32 off).
    bf16 stores each activation, q, k, v, the relative bias and P to 2^-9
    through twelve blocks, four of them softmaxes over 4096 keys; the
    reference with every linear and conv in fp8 misses the bound."""
    from portbench.bench import check
    model, plain, ref = vitdet_models(cuda)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.rand(2, 1024, 1024, 3, generator=g, device=cuda) * 4 - 2
    with torch.no_grad():
        got = model.backbone(x)
        want = plain.backbone(x)
        low = check.quantized(ref.backbone, 'fp8', x)
    assert [tuple(t.shape) for t in got] == [
        (2, 384, 128, 128), (2, 768, 64, 64), (2, 768, 32, 32)]
    assert all(t.dtype == torch.bfloat16 and
               t.is_contiguous(memory_format=torch.channels_last)
               for t in got)
    for a, b, c in zip(got, want, low):
        assert b.dtype == torch.float32
        assert check.rel_err([a], [b]) < VIT_BF16_BOUND
        assert check.rel_err([c], [b]) > VIT_BF16_BOUND


@pytest.mark.gpu
def test_vitdet_b_spans_and_no_host_round_trip(cuda):
    """With the spans on, a forward records 1 embed, 8 window, 4 global,
    12 mlp and 1 pyramid range; once the relative and position tables are
    kept, it makes no host-to-device copy and no synchronising call."""
    from torch.profiler import ProfilerActivity, profile
    model, _, _ = vitdet_models(cuda)
    x = torch.rand(2, 1024, 1024, 3, device=cuda)
    with torch.no_grad():
        model.backbone(x)                       # the kept tables, once
        _, spans = traced(lambda: model.backbone(x))
        names = [n for n, _, _ in spans]
        assert {n: names.count(n) for n in set(names)} == {
            'r3det.backbone.vit.embed': 1,
            'r3det.backbone.vit.window_attn': 8,
            'r3det.backbone.vit.global_attn': 4,
            'r3det.backbone.vit.mlp': 12, 'r3det.backbone.vit.pyramid': 1}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode('error')
            try:
                model.backbone(x)
            finally:
                torch.cuda.set_sync_debug_mode('default')
            torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if 'HtoD' in e.name]
    assert copies == []


# ---------------------------------------------------------------------------
# LSKNet's attention kernels (csrc/lsk_attn.cu, ops/lsk_attn.py)
# ---------------------------------------------------------------------------

# (H, W, C) at each stage's width, on sides that are no multiple of the
# taps' 32 x 32 tile, and stage 4's 32 x 32 at batch 8 of 1024^2
LSK_SHAPES = {'s1': (37, 45, 64), 's2': (33, 20, 128), 's3': (17, 31, 320),
              's4': (32, 32, 512)}


def lsk_inputs(dev, c, seed):
    """A seeded block of ``c`` channels on the card (every bias and BN drawn
    wide, ``test_torch_lsk_attn.seeded_block``) and its bf16 pack."""
    from test_torch_lsk_attn import seeded_block
    block = seeded_block(c, seed).to(dev)
    with torch.no_grad():
        return block, block.attn_pack(torch.bfloat16)


def lsk_randn(dev, shape, seed, std=1.0):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(
        torch.bfloat16)


def within_ulp(got, want, atol):
    """|got - want| <= one bf16 ulp of ``want`` (2^-7 |want|) + ``atol``,
    elementwise; ``atol`` a tensor or a number."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= 2 ** -7 * want.float().abs() + atol).all())


@pytest.mark.gpu
@pytest.mark.parametrize('stage', list(LSK_SHAPES))
def test_lsk_taps_kernel_matches_plain(cuda, stage):
    """bf16 against the plain form on the card (cuDNN in float32, TF32
    off). Both sum the taps and the bias in float32, in other orders
    (~2^-24 of the summed magnitudes apart), and round once, so a value
    may land on the neighbouring bf16: a1 within one bf16 ulp of the plain
    a1 plus 2^-16 of its taps' summed magnitude; a2 the same against the
    plain dilated taps of the kernel's own a1."""
    h, w, c = LSK_SHAPES[stage]
    _, p = lsk_inputs(cuda, c, 1)
    v = lsk_randn(cuda, (2, h, w, c), 2)
    _ext.reset_launches()
    with torch.no_grad():
        got = L.taps_cuda(v, p.taps, p.b0, p.bs)
        want = L.taps_reference(v, p.taps, p.b0, p.bs)
        a1 = got[..., :c].permute(0, 3, 1, 2).float().contiguous()
        ws = p.taps[25:].t().reshape(c, 1, 7, 7)
        want2 = torch.nn.functional.conv2d(a1, ws, p.bs, padding=9,
                                           dilation=3, groups=c)
        mag0 = torch.nn.functional.conv2d(
            v.permute(0, 3, 1, 2).float().abs(),
            p.taps[:25].t().reshape(c, 1, 5, 5).abs(), p.b0.abs(), padding=2,
            groups=c).permute(0, 2, 3, 1)
        mag1 = torch.nn.functional.conv2d(a1.abs(), ws.abs(), p.bs.abs(),
                                          padding=9, dilation=3, groups=c)
    assert _ext.LAUNCHES['lsk_taps'] == 1
    assert got.shape == want.shape == (2, h, w, 2 * c)
    assert within_ulp(got[..., :c], want[..., :c], 2 ** -16 * mag0)
    assert within_ulp(got[..., c:], want2.permute(0, 2, 3, 1),
                      2 ** -16 * mag1.permute(0, 2, 3, 1))


@pytest.mark.gpu
def test_lsk_taps_a1_is_zero_outside_the_map(cuda):
    """On a 6 x 9 map with conv0's bias at 4, every a2 reads a1's padding.
    The kernel matches the plain form (a1 zero there, as conv_spatial pads
    it), while a1 taken as conv0 of the padding (the bias and the edge
    taps) moves a2 by far more than the tolerance."""
    F = torch.nn.functional
    c = 64
    _, p = lsk_inputs(cuda, c, 3)
    b0 = torch.full_like(p.b0, 4.0)
    v = lsk_randn(cuda, (2, 6, 9, c), 4)
    w0 = p.taps[:25].t().reshape(c, 1, 5, 5)
    ws = p.taps[25:].t().reshape(c, 1, 7, 7)
    with torch.no_grad():
        got = L.taps_cuda(v, p.taps, b0, p.bs)[..., c:].float()
        want = L.taps_reference(v, p.taps, b0, p.bs)[..., c:].float()
        # conv0 evaluated over a canvas 9 wider, then the dilated taps
        # with no padding of their own: a1 outside the map is b0 + taps
        vn = F.pad(v.permute(0, 3, 1, 2).float(), (9, 9, 9, 9))
        a1 = F.conv2d(vn, w0, b0, padding=2, groups=c).bfloat16().float()
        wrong = F.conv2d(a1, ws, p.bs, dilation=3, groups=c).permute(
            0, 2, 3, 1)
    tol = 2 ** -7 * want.abs() + 2 ** -12 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())
    assert float((wrong - want).abs().max()) > 100 * float(tol.max())


@pytest.mark.gpu
@pytest.mark.parametrize('stage', list(LSK_SHAPES))
def test_lsk_select_kernel_matches_plain(cuda, stage):
    """bf16 against the plain form on the card. The biases add and round
    alike; the channel sums and conv_squeeze run in float32 in other
    orders (~1e-7 apart), so an s may round to the neighbouring bf16
    (2^-8 of it, s <= 1) and m moves with it: |diff| <= one bf16 ulp of m
    + 2^-8 (|b1| + |b2|) at each position and channel."""
    h, w, c = LSK_SHAPES[stage]
    _, p = lsk_inputs(cuda, c, 5)
    with torch.no_grad():
        p.wq.mul_(4.0)                     # selection weights spread wide
    b = lsk_randn(cuda, (2, h, w, c), 6)
    _ext.reset_launches()
    with torch.no_grad():
        got = L.select_cuda(b, p.b12, p.wq, p.bq)
        want = L.select_reference(b, p.b12, p.wq, p.bq)
        bb = (b + p.b12.bfloat16()).float().abs()
    assert _ext.LAUNCHES['lsk_select'] == 1
    assert got.shape == want.shape == (2, h, w, c // 2)
    assert within_ulp(got, want, 2 ** -8 * (bb[..., :c // 2]
                                            + bb[..., c // 2:]))


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['gelu', 'gate', 'residual'])
@pytest.mark.parametrize('stage', list(LSK_SHAPES))
def test_lsk_epilogue_kernel_matches_plain(cuda, stage, mode):
    """bf16 against the plain form on the card, in place. Each op computes
    in float32 on bf16 operands and rounds as PyTorch's bf16 kernels (a
    product of two bf16 is exact in float32): the gate and the residual
    bit for bit; GELU's erff within one bf16 ulp (the build keeps each
    multiply and add apart)."""
    h, w, c = LSK_SHAPES[stage]
    _, p = lsk_inputs(cuda, c, 7)
    a = lsk_randn(cuda, (2, h, w, c), 8, std=2.0)
    x = lsk_randn(cuda, (2, h, w, c), 9)
    args = {'gelu': (p.b1,), 'gate': (p.b3, x),
            'residual': (p.b2, x, p.inv, p.shift, p.ls)}[mode]
    name = f'bias_{mode}'
    _ext.reset_launches()
    with torch.no_grad():
        want = getattr(L, f'{name}_reference')(a, *args)
        got = getattr(L, f'{name}_cuda')(a, *args)
    assert got.data_ptr() == a.data_ptr()
    assert _ext.LAUNCHES[f'lsk_{name}'] == 1
    if mode == 'gelu':
        assert within_ulp(got, want, 0.0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('stage', list(LSK_SHAPES))
def test_lsk_sub_block_kernel_route_near_the_plain_route(cuda, stage):
    """A seeded block at each stage's width, on the kernels' route and on
    the eager bf16 route (kernels off), each against the same block in
    float32 (eager, TF32 off): the route folds norm1 into proj_1 and
    rounds a1 and a2 once with their biases, so it rounds elsewhere than
    the eager route; its error stays within 1.25 times the eager route's
    and under 1% of the sub-block's contribution."""
    h, w, c = LSK_SHAPES[stage]
    block, _ = lsk_inputs(cuda, c, 10)
    g = torch.Generator(cuda).manual_seed(11)
    x = torch.randn(2, c, h, w, generator=g, device=cuda).contiguous(
        memory_format=torch.channels_last)
    xb = x.bfloat16()

    def sub_block(t):
        return torch.addcmul(t, block.layer_scale_1.to(t.dtype).view(
            1, -1, 1, 1), block.attn(block.norm1(t)))
    with torch.no_grad():
        want = sub_block(x)
        assert L.refusal(xb) is None
        _ext.reset_launches()
        route = L.attention(xb, block.attn_pack(torch.bfloat16))
        launched = dict(_ext.LAUNCHES)
        with kernels(False):
            eager = sub_block(xb)
    assert [launched[f'lsk_{k}'] for k in (
        'taps', 'select', 'bias_gelu', 'bias_gate', 'bias_residual')] == \
        [1] * 5
    ref = (want - x).norm()
    kern = float((route.float() - want).norm() / ref)
    eag = float((eager.float() - want).norm() / ref)
    assert kern <= 1.25 * eag and kern < 0.01, (kern, eag)


@pytest.mark.gpu
def test_lsknet_s_backbone_kernel_route_near_the_plain_route(cuda):
    """The bf16 LSKNet-S backbone (the cell's seeded weights) on one 512^2
    image: the kernels' route and the eager route (kernels off), each
    against the float32 port: at each stage the route errs within 1.25
    times the eager route and under the 3% of the bf16 test above."""
    from portbench.bench import check
    model, plain, _ = lsknet_models(cuda)
    g = torch.Generator(cuda).manual_seed(12)
    x = torch.rand(1, 512, 512, 3, generator=g, device=cuda) * 4 - 2
    with torch.no_grad():
        want = plain.backbone(x)
        route = model.backbone(x)
        with kernels(False):
            eager = model.backbone(x)
    for a, e, r in zip(route, eager, want):
        ka, ke = check.rel_err([a], [r]), check.rel_err([e], [r])
        assert ka <= 1.25 * ke and ka < 0.03, (ka, ke)


LSK_KERNELS = ('lsk_taps', 'lsk_select', 'lsk_bias_gelu', 'lsk_bias_gate',
               'lsk_bias_residual')


@pytest.mark.gpu
def test_lsk_attn_launches_per_forward(cuda):
    """Each kernel launches 10 times a bf16 LSKNet-S forward at batch 8
    (once a block), none with kernels off, none under autograd, none in a
    Swin-T or a ResNet-50."""
    model, _, _ = lsknet_models(cuda)
    x = torch.rand(8, 128, 128, 3, device=cuda)
    _ext.reset_launches()
    with torch.no_grad():
        model.backbone(x)
    assert [_ext.LAUNCHES[n] for n in LSK_KERNELS] == [10] * 5
    _ext.reset_launches()
    with torch.enable_grad():
        model.backbone(x)
    with torch.no_grad():
        with kernels(False):
            model.backbone(x)
        swin, _ = swin_pair(cuda)
        swin.backbone(x[:2])
        net = seeded_resnet50(cuda, 0)
        net(r50_images(cuda, 1, 256))
    assert [_ext.LAUNCHES[n] for n in LSK_KERNELS] == [0] * 5


@pytest.mark.gpu
def test_lsk_attn_wrappers_raise(cuda):
    _, p = lsk_inputs(cuda, 64, 13)
    v = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    bad_taps = [(v.float(), p.taps, p.b0, p.bs),
                (v.transpose(1, 2), p.taps, p.b0, p.bs),
                (v, p.taps[:70], p.b0, p.bs),
                (v, p.taps, p.b0.bfloat16(), p.bs),
                (v[..., :36].contiguous(), p.taps[:, :36], p.b0[:36],
                 p.bs[:36])]
    for args in bad_taps:
        with pytest.raises(ValueError), torch.no_grad():
            L.taps_cuda(*args)
    bad_select = [(v.float(), p.b12, p.wq, p.bq),
                  (v[..., :40].contiguous(), p.b12[:40], p.wq, p.bq),
                  (v, p.b12.bfloat16(), p.wq, p.bq),
                  (v, p.b12, p.wq[:1], p.bq)]
    for args in bad_select:
        with pytest.raises(ValueError), torch.no_grad():
            L.select_cuda(*args)
    for args in [(v, p.b1.float()), (v.float(), p.b1),
                 (v.transpose(1, 2), p.b1), (v, p.b1[:32])]:
        with pytest.raises(ValueError), torch.no_grad():
            L.bias_gelu_cuda(*args)
    with pytest.raises(ValueError), torch.no_grad():
        L.bias_gate_cuda(v, p.b3, v[:, :4])
    with pytest.raises(ValueError), torch.no_grad():
        L.bias_residual_cuda(v, p.b2, v, p.inv.float(), p.shift, p.ls)


# ---------------------------------------------------------------------------
# Swin's window-attention kernels (csrc/swin_attn.cu, ops/swin_attn.py)
# ---------------------------------------------------------------------------

# (map side, C, heads) of Swin-T's four stages, at sizes that pad
SWIN_SHAPES = {'s1': (23, 96, 3), 's2': (15, 192, 6), 's3': (9, 384, 12),
               's4': (4, 768, 24)}


def swin_attn_inputs(dev, side, c, heads, shift, seed, batch=2):
    from r3det_tpu_torch.tools.kernel_bench import swin_block
    gen = torch.Generator(dev).manual_seed(seed)
    block = swin_block(c, heads, gen)
    block.attn.shift = 3 if shift else 0
    x = torch.randn(batch, side, side + 2, c, generator=gen,
                    device=dev).to(torch.bfloat16)
    return block, x


@pytest.mark.gpu
@pytest.mark.parametrize('stage', list(SWIN_SHAPES))
def test_swin_norm_pad_kernel_matches_plain(cuda, stage):
    """bf16 against the plain form on the card (PyTorch's LayerNorm, then
    the pad): the pad is zeros bit for bit; the two take the mean and
    variance in f32 in different orders (1e-7 relative), so a value may
    round to the neighbouring bf16: within 2^-7 relative (one bf16 ulp)."""
    side, c, heads = SWIN_SHAPES[stage]
    block, x = swin_attn_inputs(cuda, side, c, heads, False, 1)
    n = block.norm1
    with torch.no_grad():
        n.weight.normal_(1.0, 0.5)
        n.bias.normal_(0.0, 0.5)
    hp, wp = -(-side // 7) * 7, -(-(side + 2) // 7) * 7
    _ext.reset_launches()
    with torch.no_grad():
        got = A.norm_pad_cuda(x, n.weight, n.bias, n.eps, hp, wp)
        want = A.norm_pad_reference(x, n.weight, n.bias, n.eps, hp, wp)
    assert _ext.LAUNCHES['swin_norm_pad'] == 1
    assert got.shape == want.shape == (2, hp, wp, c)
    assert not got[:, side:].any() and not got[:, :, side + 2:].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('shift', [False, True], ids=['plain', 'shifted'])
@pytest.mark.parametrize('stage', list(SWIN_SHAPES))
def test_swin_window_attn_kernel_matches_plain(cuda, stage, shift):
    """bf16 against the plain form on the card. Both take the scores,
    bias, mask and softmax in f32 and round P and the output to bf16; the
    f32 sums and exponentials differ in order and last bits, so a P may
    round to the neighbouring bf16 (2^-8 of it) and the output with it:
    |diff| <= 2^-8 max|v| + one bf16 ulp of the output."""
    from r3det_tpu_torch.models.swin import padded
    side, c, heads = SWIN_SHAPES[stage]
    block, x = swin_attn_inputs(cuda, side, c, heads, shift, 2)
    msa = block.attn.w_msa
    w = side + 2
    with torch.no_grad():
        qkv = msa.qkv(A.norm_pad_reference(x, block.norm1.weight,
                                           block.norm1.bias, 1e-5,
                                           padded(side, 7), padded(w, 7)))
    table = msa.relative_position_bias_table
    s = block.attn.shift
    _ext.reset_launches()
    with torch.no_grad():
        got = A.window_attn_cuda(qkv, table, heads, 7, s, side, w)
        want = A.window_attn_reference(qkv, table, heads, 7, s, side, w)
    assert _ext.LAUNCHES['swin_window_attn'] == 1
    assert got.shape == want.shape == (2, side, w, c)
    vmax = float(qkv[..., 2 * c:].float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8 * vmax)


def swin_sub_block_errors(model, ref, stage, block, x):
    """The attention sub-block (norm1 through the residual add) of
    ``model.backbone.stages[stage].blocks[block]`` in bf16 on the kernels'
    route and on the eager route, each against the f32 reference's same
    sub-block on the same input: (kernel err, eager err)."""
    from portbench.bench import check
    blk = model.backbone.stages[stage].blocks[block]
    rblk = ref.backbone.stages[stage].blocks[block]
    b, h, w, c = x.shape
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        want = rblk.attn(rblk.norm1(x.view(b, h * w, c)), (h, w)) \
            + x.view(b, h * w, c)
        assert A.refusal(xb, blk.attn.w_msa.num_heads, blk.attn.window,
                         blk.norm1.weight) is None
        route = xb + blk.attn.kernel_forward(xb, blk.norm1)
        eager = xb + blk.attn(blk.norm1(xb))
    want = want.view(b, h, w, c)
    return check.rel_err([route], [want]), check.rel_err([eager], [want])


@pytest.mark.gpu
@pytest.mark.parametrize('side', [56, 256], ids=['224px', '1024px'])
def test_swin_t_sub_block_kernel_error_within_eager(cuda, side):
    """A stage-1 shifted and unshifted block of Swin-T (published widths,
    the cell's seeded weights) at the stage-1 shapes of a 224^2 and a
    1024^2 image: against the f32 reference, the kernels' route errs no
    more than the eager bf16 route (which also rounds q * scale, the
    scores and the bias to bf16)."""
    model, ref = swin_pair(cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(1, side, side, 96, generator=gen, device=cuda)
    for block in (0, 1):
        kern, eager = swin_sub_block_errors(model, ref, 0, block, x)
        assert kern <= eager, (block, kern, eager)
        assert kern < 0.01, (block, kern)


@pytest.mark.gpu
@pytest.mark.parametrize('size', [224, 1024])
def test_swin_t_backbone_kernel_error_within_eager(cuda, size):
    """The whole bf16 Swin-T backbone at 224^2 and 1024^2 against the f32
    reference: the kernels' route errs no more than the eager route at
    each output, and both stay within the 3% of the 224^2 test above."""
    from portbench.bench import check
    model, ref = swin_pair(cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    x = torch.rand(1, size, size, 3, generator=gen, device=cuda) * 4 - 2
    with torch.no_grad():
        want = ref.backbone(x)
        route = model.backbone(x)
        with kernels(False):
            eager = model.backbone(x)
    for a, e, r in zip(route, eager, want):
        ka, ke = check.rel_err([a], [r]), check.rel_err([e], [r])
        assert ka <= ke and ka < 0.03, (size, ka, ke)


@pytest.mark.gpu
def test_swin_attn_launches_per_forward(cuda):
    """Each kernel launches 12 times a bf16 Swin-T forward (once a block),
    none with kernels off, none under autograd, none in a ResNet-50."""
    model, _ = swin_pair(cuda)
    x = torch.rand(2, 224, 224, 3, device=cuda)
    names = ('swin_norm_pad', 'swin_window_attn')
    _ext.reset_launches()
    with torch.no_grad():
        model.backbone(x)
    assert [_ext.LAUNCHES[n] for n in names] == [12, 12]
    _ext.reset_launches()
    with torch.enable_grad():
        model.backbone(x)
    with torch.no_grad():
        with kernels(False):
            model.backbone(x)
        net = seeded_resnet50(cuda, 0)
        net(r50_images(cuda, 1, 256))
    assert [_ext.LAUNCHES[n] for n in names] == [0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize('dims,heads', [(1024, 32), (1536, 48)],
                         ids=['swin_b_stage4', 'swin_l_stage4'])
def test_swin_wide_block_takes_the_eager_route(cuda, dims, heads):
    """A head_dim-32 block wider than the norm kernel holds (Swin-B's and
    Swin-L's stage 4) takes the eager route in bf16 on the card: it runs,
    launches neither kernel, and equals the block with kernels off."""
    from r3det_tpu_torch.models.swin import SwinBlock
    block = SwinBlock(dims, heads, 4 * dims, 7, True).to(cuda)
    gen = torch.Generator(cuda).manual_seed(5)
    x = torch.randn(2, 9, 9, dims, generator=gen,
                    device=cuda).to(torch.bfloat16)
    _ext.reset_launches()
    with torch.no_grad():
        assert 'C a multiple' in A.refusal(x, heads, 7, block.norm1.weight)
        got = block(x)
        with kernels(False):
            want = block(x)
    assert [_ext.LAUNCHES[n] for n in ('swin_norm_pad',
                                       'swin_window_attn')] == [0, 0]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_swin_attn_wrappers_raise(cuda):
    qkv = torch.zeros(1, 14, 14, 288, dtype=torch.bfloat16, device=cuda)
    table = torch.zeros(169, 3, device=cuda)
    bad = [
        (qkv.float(), table, 3, 7, 3),                       # f32
        (qkv, torch.zeros(169, 6, device=cuda), 6, 7, 3),    # head_dim 16
        (torch.zeros(1, 24, 24, 288, dtype=torch.bfloat16, device=cuda),
         torch.zeros(529, 3, device=cuda), 3, 12, 6),        # window 12
        (qkv[:, :, :13], table, 3, 7, 3),                    # 13 % 7
        (qkv.transpose(1, 2), table, 3, 7, 3),               # strided
        (qkv, table[:100], 3, 7, 3),                         # table shape
        (qkv, table.double(), 3, 7, 3),                      # table dtype
        (qkv, table, 3, 7, 7),                               # shift 7
    ]
    for q, t, heads, window, shift in bad:
        with pytest.raises(ValueError), torch.no_grad():
            A.window_attn_cuda(q, t, heads, window, shift, 12, 12)
    x = torch.zeros(1, 12, 12, 96, dtype=torch.bfloat16, device=cuda)
    w, b = torch.ones(96, device=cuda), torch.zeros(96, device=cuda)
    for args in [(x.float(), w, b), (x[..., :90].contiguous(), w[:90],
                                     b[:90]),           # C % 8
                 (x.transpose(1, 2), w, b), (x, w.bfloat16(), b)]:
        with pytest.raises(ValueError):
            A.norm_pad_cuda(*args, 1e-5, 14, 14)
    with pytest.raises(ValueError):
        A.norm_pad_cuda(x, w, b, 1e-5, 7, 14)                # pad < map


# ---------------------------------------------------------------------------
# Where each route launches: one predict step a route
# ---------------------------------------------------------------------------

# route -> (benchmark configuration, dtype, config fields, build options)
STEP_ROUTES = {
    'r3det_r50_bf16': ('r3det_r50', torch.bfloat16, {}, {}),
    'rretinanet_r50_bf16': ('rretinanet_obb_r50', torch.bfloat16, {}, {}),
    'rretinanet_swin_t_bf16': ('rretinanet_obb_swin_t', torch.bfloat16, {},
                               {}),
    'rretinanet_lsknet_s_bf16': ('rretinanet_obb_lsknet_s', torch.bfloat16,
                                 {}, {}),
    'rretinanet_vitdet_b_bf16': ('rretinanet_obb_vitdet_b', torch.bfloat16,
                                 {}, {}),
    'r3det_r50_int8_static': ('r3det_r50', torch.bfloat16,
                              dict(quantize='static', quantize_head='static'),
                              dict(int8_act=True)),
    'r3det_r50_fused_blocks': ('r3det_r50', torch.bfloat16, {},
                               dict(fused_blocks=True)),
    'r3det_r50_stem_pool': ('r3det_r50', torch.bfloat16, {},
                            dict(stem_fused_kernel=False,
                                 stem_pool_kernel=True)),
    'r3det_r50_f32': ('r3det_r50', torch.float32, {}, {}),
}

# route -> the kernels one predict step launches (batch 2 of 256^2, seeded
# weights), each with its count; kernels that do not launch are left out
STEP_LAUNCHES = {
    'r3det_r50_bf16': {'rotated_iou': 1, 'nms_sweep': 1, 'frm_sample': 1,
                       'stem_conv_pool': 1, 'conv_epilogue': 48},
    'rretinanet_r50_bf16': {'rotated_iou': 1, 'nms_sweep': 1,
                            'stem_conv_pool': 1, 'conv_epilogue': 48},
    'rretinanet_swin_t_bf16': {'rotated_iou': 1, 'nms_sweep': 1,
                               'swin_norm_pad': 12, 'swin_window_attn': 12},
    'rretinanet_lsknet_s_bf16': {'rotated_iou': 1, 'nms_sweep': 1,
                                 'lsk_taps': 10, 'lsk_select': 10,
                                 'lsk_bias_gelu': 10, 'lsk_bias_gate': 10,
                                 'lsk_bias_residual': 10},
    'rretinanet_vitdet_b_bf16': {'rotated_iou': 1, 'nms_sweep': 1},
    'r3det_r50_int8_static': {'rotated_iou': 1, 'nms_sweep': 1,
                              'frm_sample': 1, 'stem_conv_pool_q8': 1,
                              'int8_conv': 155},
    'r3det_r50_fused_blocks': {'rotated_iou': 1, 'nms_sweep': 1,
                               'frm_sample': 1, 'stem_conv_pool': 1,
                               'bottleneck': 10, 'conv_epilogue': 18},
    'r3det_r50_stem_pool': {'rotated_iou': 1, 'nms_sweep': 1,
                            'frm_sample': 1, 'stem_pool': 1,
                            'conv_epilogue': 48},
    'r3det_r50_f32': {'rotated_iou': 1, 'nms_sweep': 1},
}


def step_launches(dev, route):
    """The launches of one predict step on ``route``, with the detector's
    kernels on and off: (on, off), each {kernel: count} of the kernels
    that launched."""
    import json
    from pathlib import Path

    from portbench.bench import common
    from r3det_tpu_torch.models.quant import calibrate
    name, dtype, fields, options = STEP_ROUTES[route]
    root = Path(__file__).resolve().parent.parent / 'portbench'
    cfg = json.loads((root / 'configs' / f'{name}.json').read_text())
    pcfg = common.program_config(cfg)._replace(**fields)
    model = build_detector(pcfg, dtype=dtype, device=dev,
                           **cfg['build_options'], **options)
    model.load_state_dict(seeded_state_dict(model, 0))
    size = 256
    images = torch.rand(2, size, size, 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(0)) * 4 - 2
    if fields:
        calibrate(model, [images])
    sizes = tuple((-(-size // s),) * 2 for s in pcfg.strides)
    step = make_predict_step(model, pcfg, sizes, img_shape=(size, size))

    def launches():
        _ext.reset_launches()
        step(images)
        torch.cuda.synchronize()
        return {k: v for k, v in _ext.LAUNCHES.items() if v}
    on = launches()
    use_kernels(model, False)
    return on, launches()


@pytest.mark.gpu
@pytest.mark.parametrize('route', list(STEP_ROUTES))
def test_predict_step_launches_per_route(cuda, route):
    """Each route's predict step launches each kernel as often as pinned,
    and none with the detector's kernels off."""
    on, off = step_launches(cuda, route)
    assert on == STEP_LAUNCHES[route]
    assert off == {}
