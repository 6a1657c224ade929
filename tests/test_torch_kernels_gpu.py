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
from r3det_tpu_torch.models.detectors import (DetectorConfig, TestCfg,
                                              build_detector, use_kernels)
from r3det_tpu_torch.models.resnet import Bottleneck, ResNet
from r3det_tpu_torch.ops import bottleneck_fuse as K5
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.ops import int8_conv as Q
from r3det_tpu_torch.ops import rotated_iou as K1
from r3det_tpu_torch.ops import stem_pool as K3
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.convert import seeded_state_dict


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
    from r3det_tpu_torch.ops import nms
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
    assert torch.equal(keep, nms.greedy_keep_streamed(
        b, valid, labels, 0.2, vcount, kernels=False))
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
    want = nms.multiclass_nms_rotated_batched(mboxes, mscores, kernels=False,
                                              **args)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


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
        got = K2.frm_sample(x, feat, rois, 1 / stride, quirk)
        assert _ext.LAUNCHES['frm_sample'] == before + 1
        want = K2.frm_sample_reference(x, feat, rois, 1 / stride, quirk)
        assert torch.equal(got, want)
    # f32, a channel count that is no multiple of 8, a misaligned view:
    # both wrappers raise
    x12 = x[..., :12].contiguous()
    for args in ((x.float(), feat.float()), (x12, x12),
                 (misaligned(x), feat), (x, misaligned(feat))):
        with pytest.raises(ValueError):
            K2.frm_sample(*args, rois, 1 / stride)
        with pytest.raises(ValueError):
            K2.frm_sample_levels([args[0]], [args[1]], [rois], [1 / stride])
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


@pytest.mark.gpu
def test_r3det_frm_points5_runs_on_card(cuda):
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
    model.frm_0.kernels = False
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
            m.kernels = False
            want = m(x)
            m.kernels = True
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
    got = Q.qconv(*args, torch.bfloat16)
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
        K3.stem_conv_pool(x, k, s, s, dtype=torch.float32)
    b = torch.zeros(1, 5, 8, device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        K1.rotated_iou_cuda(b, b)
    x, ws = bottleneck_args(np.random.RandomState(0), 32, cuda)
    with pytest.raises(ValueError):                        # F = 32
        K5.fused_bottleneck(x, *ws)
    args, kw = fused_args(np.random.RandomState(1), (1, 1), 64, 256,
                          EPILOGUES['affine_res_relu'][3], cuda)
    bad = (
        dict(kw, residual=kw['residual'].float()),           # f32 residual
        dict(kw, residual=kw['residual'][:, :8].contiguous()),  # wrong shape
        dict(kw, affine=tuple(t.float() for t in kw['affine'])),
    )
    for b in bad:
        with pytest.raises(ValueError):
            Q.qconv_fused(*args, **b)
    with pytest.raises(ValueError):                        # Co = 32
        Q.qconv_fused(args[0], *args[1:2], args[2][..., :32],
                      args[3][:32], None, *args[5:])
    with pytest.raises(ValueError):                        # f32 input
        Q.qconv_fused(args[0].float(), *args[1:], **kw)


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
    assert {k: _ext.LAUNCHES[k] for k in ('rotated_iou', 'frm_sample',
                                          'stem_conv_pool')} == dict(
        rotated_iou=steps, frm_sample=steps, stem_conv_pool=steps)
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
