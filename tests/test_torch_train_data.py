"""The port's train-side data path against OpenCV and the JAX package.

- ``warp_affine_linear`` equals ``cv2.warpAffine(..., INTER_LINEAR)`` bit
  for bit: uint8 images of 1 and 3 channels, square and not, at random
  angles and at +-90 / 180, output sizes from ``auto_bound`` and others,
  widths with and without a tail past the last 16 columns, matrices that
  put taps outside the image (constant 0 border);
- ``get_rotation_matrix_2d`` and ``transform_points`` equal
  ``cv2.getRotationMatrix2D`` and ``cv2.transform`` exactly (float64);
- ``RRandomFlip`` and ``PolyRandomRotate`` (v1 / v3, seeds 0-4, the
  class-9 snap, ``auto_bound``, the ``None`` case) on the same inputs and
  the same ``RandomState`` as ``r3det_tpu.datasets.transforms``: images
  bit for bit, every box within 1e-5 (both run the same numpy box rules;
  the port re-fits boxes with its own minimum-area rectangle, bit-equal
  to cv2's in tests/test_torch_rtransforms_np.py);
- ``TrainPipeline.from_config`` on the dota1_0 and ms_rr_v3 pipelines,
  ``pad_gt``'s truncation, and ``DetLoader`` over a fake-DOTA split:
  JAX's batches (its loader with one worker) with one and with four
  workers;
- ``convert_torch_resnet`` on a synthetic torchvision state dict (depth
  50, with and without the stem fold) equals JAX's through ``from_flax``.

Images and boxes come from numpy seeds.
"""
import math
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from r3det_tpu.datasets import dota as JD
from r3det_tpu.datasets import loader as JLD
from r3det_tpu.datasets import transforms as J
from r3det_tpu.utils import checkpoint as JC
from r3det_tpu_torch.datasets import dota as TD
from r3det_tpu_torch.datasets import loader as TLD
from r3det_tpu_torch.datasets import transforms as T
from r3det_tpu_torch.tools import make_fake_dota
from r3det_tpu_torch.utils import checkpoint as TC
from r3det_tpu_torch.utils.config import Config
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)

BOX_TOL = 1e-5


# ------------------------------------------------------------- warpAffine

def _warp_case(seed):
    """(image, matrix, dsize) of one random case."""
    rng = np.random.RandomState(seed)
    h, w = (int(v) for v in rng.randint(1, 96, 2))
    img = rng.randint(0, 256, (h, w) if seed % 2 else (h, w, 3), np.uint8)
    angle = [float(rng.uniform(-180, 180)), 90, -90, 180, -180,
             float(rng.uniform(-10, 10))][seed % 6]
    m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1)
    kind = seed % 4
    if kind == 0:                        # auto_bound's output size
        ac, as_ = abs(math.cos(angle)), abs(math.sin(angle))
        dsize = (int(np.rint(h * as_ + w * ac)),
                 int(np.rint(h * ac + w * as_)))
    elif kind == 1:                      # shifted and scaled: taps outside
        m = m * rng.uniform(0.5, 2.0) + np.array(
            [[0, 0, rng.uniform(-40, 40)], [0, 0, rng.uniform(-40, 40)]])
        dsize = (int(rng.randint(1, 120)), int(rng.randint(1, 120)))
    else:
        dsize = (w, h)
    return img, m, tuple(max(1, d) for d in dsize)


@pytest.mark.parametrize('seed', range(48))
def test_warp_affine_linear_matches_cv2(seed):
    img, m, dsize = _warp_case(seed)
    want = cv2.warpAffine(img, m, dsize, flags=cv2.INTER_LINEAR)
    got = T.warp_affine_linear(torch.from_numpy(img), m, dsize)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('hw,angle', [((256, 256), 37.5), ((200, 333), -121.0),
                                      ((97, 250), 90), ((128, 64), 180)])
def test_warp_affine_linear_matches_cv2_larger(hw, angle):
    """Sizes with many 16-column steps, as the train pipeline's."""
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,), np.uint8)
    m = cv2.getRotationMatrix2D((hw[1] / 2 - 0.5, hw[0] / 2 - 0.5), angle, 1)
    want = cv2.warpAffine(img, m, hw[::-1], flags=cv2.INTER_LINEAR)
    got = T.warp_affine_linear(torch.from_numpy(img), m, hw[::-1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_affine_linear_rejects_float():
    with pytest.raises(ValueError, match='uint8'):
        T.warp_affine_linear(torch.zeros(4, 4, 3), np.eye(2, 3), (4, 4))


def _round_f32(exact):
    """The float32 nearest a Fraction, ties to even."""
    from fractions import Fraction
    f = np.float32(float(exact))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - exact)
        even = not (np.array(c).view(np.uint32) & 1)
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma32_rounds_once():
    """The fused multiply-add that the warp's arithmetic needs, against
    exact rationals: two sums that lie 2^-60 off a float32 midpoint
    (1 + 2^-24 + 2^-60 and 1 + 3 * 2^-24 - 2^-60), which a float64 sum
    rounds onto the midpoint and a second rounding to even then misses,
    and random triples."""
    from fractions import Fraction
    f = np.float32
    cases = [(f((1 + 2 ** -12) * 2 ** -24), f(1 - 2 ** -12 + 2 ** -24),
              f(1.0), f(1 + 2 ** -23)),
             (f((1 - 2 ** -18) * 2 ** -24), f(1 + 2 ** -18),
              f(1 + 2 ** -23), f(1 + 2 ** -23))]
    for a, b, c, want in cases:
        ta, tb, tc = (torch.tensor([v]) for v in (a, b, c))
        naive = (ta.double() * tb.double() + tc.double()).float()
        assert naive.item() != float(want)      # the case is a real one
        assert T._fma32(ta, tb, tc).item() == float(want)
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, 256).astype(np.float32)
    b = rng.randint(-255, 256, 256).astype(np.float32)
    c = (rng.randint(0, 256, 256) * rng.uniform(0, 1, 256) ** 9).astype(
        np.float32)
    got = T._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(256):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        assert got[i] == _round_f32(exact)


@pytest.mark.parametrize('seed', range(4))
def test_rotation_matrix_and_transform_match_cv2(seed):
    rng = np.random.RandomState(seed)
    for angle in [float(rng.uniform(-180, 180)), 90, -180, 0, 45.5]:
        center = (float(rng.uniform(0, 1024)), float(rng.uniform(0, 1024)))
        scale = [1.0, float(rng.uniform(0.5, 2))][seed % 2]
        m = T.get_rotation_matrix_2d(center, angle, scale)
        want = cv2.getRotationMatrix2D(center, angle, scale)
        assert m.dtype == np.float64
        np.testing.assert_array_equal(m, want)
        pts = rng.uniform(-200, 1200, (64, 2))
        np.testing.assert_array_equal(
            T.transform_points(pts, m), cv2.transform(pts[:, None], m)[:, 0])
    assert T.transform_points(np.zeros((0, 2)), m).shape == (0, 2)


# ------------------------------------------------------ flips and rotation

def _boxes(rng, n, h, w, version):
    lo = {'v1': -math.pi / 2, 'v2': -math.pi / 4, 'v3': -math.pi / 2}
    hi = {'v1': 0.0, 'v2': 3 * math.pi / 4, 'v3': math.pi / 2}
    return np.stack([rng.uniform(w * 0.2, w * 0.8, n),
                     rng.uniform(h * 0.2, h * 0.8, n),
                     rng.uniform(8, 40, n), rng.uniform(8, 40, n),
                     rng.uniform(lo[version], hi[version], n)],
                    -1).astype(np.float32)


def _sample(seed, h, w, version, labels=None, n=6):
    rng = np.random.RandomState(100 + seed)
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    boxes = _boxes(rng, n, h, w, version)
    if version == 'v1':
        boxes[0, 4] = -math.pi / 2           # the v1 flip's exception
    labels = rng.randint(0, 15, n) if labels is None else np.asarray(labels)
    return img, boxes, labels.astype(np.int64)


def _pair(img, boxes, labels):
    j = dict(img=img.copy(), gt_bboxes=boxes.copy(), gt_labels=labels.copy())
    t = dict(img=torch.from_numpy(img.copy()), gt_bboxes=boxes.copy(),
             gt_labels=labels.copy())
    return j, t


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    np.testing.assert_array_equal(got['img'].cpu().numpy(), want['img'])
    np.testing.assert_allclose(got['gt_bboxes'], want['gt_bboxes'],
                               rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got['gt_labels'], want['gt_labels'])


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
@pytest.mark.parametrize('direction', ['horizontal', 'vertical', 'diagonal'])
def test_rrandomflip_matches_jax(direction, version):
    img, boxes, labels = _sample(0, 40, 56, version)
    kw = dict(flip_ratio=1.0, direction=direction, version=version)
    np.testing.assert_array_equal(
        T.RRandomFlip(**kw).bbox_flip(boxes, img.shape, direction),
        J.RRandomFlip(**kw).bbox_flip(boxes, img.shape, direction))
    j, t = _pair(img, boxes, labels)
    want = J.RRandomFlip(rng=np.random.RandomState(3), **kw)(j)
    got = T.RRandomFlip(rng=np.random.RandomState(3), **kw)(t)
    _assert_same(got, want)
    assert got['flip'] and got['flip_direction'] == direction


def test_rrandomflip_draws_as_jax():
    """flip_ratio 0.5 over a run of samples: the same draws, the same flips."""
    jr, tr = np.random.RandomState(7), np.random.RandomState(7)
    jf = J.RRandomFlip(0.5, version='v2', rng=jr)
    tf = T.RRandomFlip(0.5, version='v2', rng=tr)
    flips = []
    for seed in range(8):
        j, t = _pair(*_sample(seed, 24, 30, 'v2'))
        want, got = jf(j), tf(t)
        _assert_same(got, want)
        flips.append(got['flip'])
    assert any(flips) and not all(flips)


def _assert_rotated_same(got, want):
    """``PolyRandomRotate``'s outputs: the image bit for bit, the labels
    exactly, every box within BOX_TOL of JAX's."""
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got['img'].cpu().numpy(), want['img'])
    np.testing.assert_array_equal(got['gt_labels'], want['gt_labels'])
    assert got['gt_bboxes'].shape == want['gt_bboxes'].shape
    np.testing.assert_allclose(got['gt_bboxes'], want['gt_bboxes'], rtol=0,
                               atol=BOX_TOL)


@pytest.mark.parametrize('version', ['v1', 'v3'])
@pytest.mark.parametrize('seed', range(5))
def test_polyrandomrotate_matches_jax(seed, version):
    """rotate_ratio 0.5: some seeds rotate, some take the angle-0 path;
    odd seeds carry a storage tank (class 9) and snap the angle."""
    labels = [9, 1, 2, 3, 4, 5] if seed % 2 else None
    img, boxes, labels = _sample(seed, 64, 80, version, labels)
    j, t = _pair(img, boxes, labels)
    want = J.PolyRandomRotate(version=version,
                              rng=np.random.RandomState(seed))(j)
    got = T.PolyRandomRotate(version=version,
                             rng=np.random.RandomState(seed))(t)
    _assert_rotated_same(got, want)
    assert got['rotate'] == want['rotate']
    assert got['rotate_angle'] == want['rotate_angle']
    if seed % 2 and want['rotate']:
        assert want['rotate_angle'] in (90, 180, -90, -180)


@pytest.mark.parametrize('seed', range(3))
def test_polyrandomrotate_auto_bound_matches_jax(seed):
    img, boxes, labels = _sample(seed, 48, 72, 'v3')
    j, t = _pair(img, boxes, labels)
    kw = dict(rotate_ratio=1.0, auto_bound=True, version='v3')
    want = J.PolyRandomRotate(rng=np.random.RandomState(seed), **kw)(j)
    got = T.PolyRandomRotate(rng=np.random.RandomState(seed), **kw)(t)
    _assert_rotated_same(got, want)


@pytest.mark.parametrize('rotate_ratio', [0.0, 1.0])
def test_polyrandomrotate_none_when_no_gt_survives(rotate_ratio):
    """Boxes of w <= 5 die in the size filter, rotated or not; so do no
    boxes at all."""
    img, boxes, labels = _sample(0, 40, 40, 'v1')
    boxes[:, 2] = 4.0
    for b in (boxes, boxes[:0]):
        j, t = _pair(img, b, labels[:len(b)])
        kw = dict(rotate_ratio=rotate_ratio, version='v1')
        assert J.PolyRandomRotate(rng=np.random.RandomState(0), **kw)(j) \
            is None
        assert T.PolyRandomRotate(rng=np.random.RandomState(0), **kw)(t) \
            is None


# ----------------------------------------------------------- the pipeline

def _pipeline_cfg(name):
    cfg = Config.fromfile(f'configs/{name}')
    return [dict(s) for s in cfg.data.train.pipeline]


def _shrink(pipeline, size):
    for s in pipeline:
        if s['type'] == 'RResize':
            s['img_scale'] = (size, size)
    return pipeline


@pytest.mark.parametrize('config,version', [
    ('_base_/datasets/dota1_0.py', 'v1'),
    ('rretinanet/rretinanet_obb_r50_fpn_1x_dota_ms_rr_v3.py', 'v3')])
def test_train_pipeline_from_config_matches_jax(config, version):
    stages = _shrink(_pipeline_cfg(config), 96)
    jp = J.TrainPipeline.from_config(stages, version=version, max_gt=8,
                                     seed=5)
    tp = T.TrainPipeline.from_config(stages, version=version, max_gt=8,
                                     seed=5, device='cpu')
    assert [type(s).__name__ for s in jp.stages] == \
        [type(s).__name__ for s in tp.stages]
    jp.pad_to(96, 96)
    tp.pad_to(96, 96)
    for seed in range(6):
        img, boxes, labels = _sample(seed, 120, 150, version,
                                     [9] + [1] * 5 if seed == 3 else None)
        want = jp(dict(img=img.copy(), gt_bboxes=boxes.copy(),
                       gt_labels=labels.copy()))
        got = tp(dict(img=img.copy(), gt_bboxes=boxes.copy(),
                      gt_labels=labels.copy()))
        if want is None:
            assert got is None
            continue
        assert got['image'].dtype == torch.float32
        assert got['image'].shape == (96, 96, 3)
        np.testing.assert_array_equal(got['image'].numpy(), want['image'])
        np.testing.assert_allclose(got['gt_bboxes'].numpy(),
                                   want['gt_bboxes'], rtol=0, atol=BOX_TOL)
        for k in ('gt_labels', 'gt_mask'):
            assert got[k].dtype == torch.from_numpy(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_train_pipeline_init_matches_jax():
    kw = dict(img_scale=(64, 64), version='v3', with_rotate=True,
              rotate_kwargs=dict(rotate_ratio=1.0), max_gt=4, seed=2)
    jp, tp = J.TrainPipeline(**kw), T.TrainPipeline(device='cpu', **kw)
    img, boxes, labels = _sample(1, 64, 64, 'v3')
    want = jp(dict(img=img.copy(), gt_bboxes=boxes.copy(),
                   gt_labels=labels.copy()))
    got = tp(dict(img=img.copy(), gt_bboxes=boxes.copy(),
                  gt_labels=labels.copy()))
    np.testing.assert_array_equal(got['image'].numpy(), want['image'])
    np.testing.assert_allclose(got['gt_bboxes'].numpy(), want['gt_bboxes'],
                               rtol=0, atol=BOX_TOL)


@pytest.mark.parametrize('n,max_gt', [(0, 4), (3, 4), (4, 4), (9, 4)])
def test_pad_gt_matches_jax(n, max_gt):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, n, 100, 100, 'v1')
    labels = rng.randint(0, 15, n)
    for got, want in zip(T.pad_gt(boxes, labels, max_gt),
                         J.pad_gt(boxes, labels, max_gt)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if n > max_gt:                      # the largest boxes by area stay
        kept = T.pad_gt(boxes, labels, max_gt)[0]
        area = boxes[:, 2] * boxes[:, 3]
        assert sorted(kept[:, 2] * kept[:, 3]) == \
            sorted(np.sort(area)[-max_gt:])


def test_train_side_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        T.TrainPipeline()
    with pytest.raises(RuntimeError, match='no CUDA card'):
        TLD.DetLoader([], None)


# ---------------------------------------------------------------- loader

@pytest.fixture(scope='module')
def fake_split(tmp_path_factory):
    """Two 700^2 scenes split at 512 with gap 128 (8 patches)."""
    root = tmp_path_factory.mktemp('fake_dota_train')
    split = str(root / 'split')
    make_fake_dota.main(['--out', str(root / 'raw'), '--split-out', split,
                         '--num-images', '2'])
    return split


def _loader_pair(split, num_workers, **kw):
    stages = _shrink(_pipeline_cfg(
        'rretinanet/rretinanet_obb_r50_fpn_1x_dota_ms_rr_v3.py'), 128)
    args = (split + '/annfiles/', split + '/images/')
    dkw = dict(version='v3', classes=make_fake_dota.CLASSES)
    jp = J.TrainPipeline.from_config(stages, version='v3', max_gt=16, seed=1)
    tp = T.TrainPipeline.from_config(stages, version='v3', max_gt=16, seed=1,
                                     device='cpu')
    jp.pad_to(128, 128)
    tp.pad_to(128, 128)
    jl = JLD.DetLoader(JD.DOTADataset(*args, **dkw), jp, seed=3,
                       num_workers=1, **kw)
    tl = TLD.DetLoader(TD.DOTADataset(*args, **dkw), tp, seed=3,
                       num_workers=num_workers, device='cpu', **kw)
    return jl, tl


@pytest.mark.parametrize('num_workers', [1, 4])
def test_det_loader_matches_jax(fake_split, num_workers):
    """Two epochs of batches of 3 (drop_last), as JAX's loader with one
    worker gives them: the same permutation, draws and resamples."""
    jl, tl = _loader_pair(fake_split, num_workers, batch_size=3)
    assert len(tl) == len(jl) > 0
    n = 0
    for _ in range(2):
        for want, got in zip(jl, tl, strict=True):
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape
                assert got[k].dtype == torch.from_numpy(want[k]).dtype
                if k == 'gt_bboxes':
                    np.testing.assert_allclose(got[k].numpy(), want[k],
                                               rtol=0, atol=BOX_TOL)
                else:
                    np.testing.assert_array_equal(got[k].numpy(), want[k])
            n += 1
    assert n == 2 * len(tl)


@pytest.mark.parametrize('kw', [
    dict(batch_size=3, drop_last=False, shuffle=False),
    dict(batch_size=2, process_index=1, process_count=3)])
def test_det_loader_len_and_strides_match_jax(fake_split, kw):
    jl, tl = _loader_pair(fake_split, 2, **kw)
    assert len(tl) == len(jl)
    assert list(tl._epoch_indices()) == list(jl._epoch_indices())
    got = [b['gt_mask'].sum().item() for b in tl]
    want = [int(b['gt_mask'].sum()) for b in jl]
    assert got == want and len(got) == len(tl)


def test_det_loader_stops_its_threads(fake_split):
    _, tl = _loader_pair(fake_split, 4, batch_size=1, prefetch=1)
    before = threading.active_count()
    it = iter(tl)
    next(it)
    assert threading.active_count() > before
    it.close()                      # the consumer walks away mid-epoch
    deadline = time.monotonic() + 10
    while threading.active_count() > before and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_det_loader_raises_the_pipelines_error(fake_split):
    _, tl = _loader_pair(fake_split, 2, batch_size=2)

    def broken(sample):
        raise KeyError('broken stage')
    tl.pipeline = broken
    with pytest.raises(KeyError, match='broken stage'):
        next(iter(tl))


# -------------------------------------------------------------- converter

def _torchvision_resnet(depth, seed):
    """A torchvision-style ResNet state dict (names and shapes) from a
    numpy seed."""
    rng = np.random.RandomState(seed)
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    sd = {}

    def bn(k, c):
        sd[k + '.weight'] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[k + '.bias'] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[k + '.running_mean'] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[k + '.running_var'] = rng.uniform(0.5, 2, c).astype(np.float32)
        sd[k + '.num_batches_tracked'] = np.array(0)

    sd['conv1.weight'] = rng.normal(0, 0.1, (64, 3, 7, 7)).astype(np.float32)
    bn('bn1', 64)
    inplanes = 64
    for stage, n in enumerate(blocks):
        f = 64 * 2 ** stage
        for b in range(n):
            k = f'layer{stage + 1}.{b}'
            for i, (cin, cout, ks) in enumerate(
                    [(inplanes, f, 1), (f, f, 3), (f, 4 * f, 1)], 1):
                sd[f'{k}.conv{i}.weight'] = rng.normal(
                    0, 0.05, (cout, cin, ks, ks)).astype(np.float32)
                bn(f'{k}.bn{i}', cout)
            if b == 0:
                sd[f'{k}.downsample.0.weight'] = rng.normal(
                    0, 0.05, (4 * f, inplanes, 1, 1)).astype(np.float32)
                bn(f'{k}.downsample.1', 4 * f)
            inplanes = 4 * f
    sd['fc.weight'] = np.zeros((10, 2048), np.float32)
    return sd


@pytest.mark.parametrize('s2d', [True, False])
def test_convert_torch_resnet_matches_jax(s2d):
    sd = _torchvision_resnet(50, 0)
    params, stats = JC.convert_torch_resnet(sd, 50, s2d)
    want = from_flax({'params': params, 'batch_stats': stats})
    got = TC.convert_torch_resnet(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, 50, s2d)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert got['conv1.kernel'].shape == ((4, 4, 12, 64) if s2d
                                         else (7, 7, 3, 64))
