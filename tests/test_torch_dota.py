"""The port's DOTA data and evaluation path against the JAX package's, on
one split that the port's fake-DOTA maker writes and both packages read.

- ``DOTADataset``: the same ids, labels and polygons exactly, boxes within
  test_torch_rtransforms_np's tolerance (x, y, w, h 1e-3 px, theta 1e-5
  rad), the same decoded images (``image_io`` against cv2);
- ``eval_rbbox_map`` within 1e-12 of JAX's on results made from a numpy
  seed, area and 11-point AP; ``merge_det`` the same ids, keep sets and
  arrays; ``format_results`` byte-equal files; results with ``nproc`` 1
  and 4 equal;
- ``polygon_iou`` / ``polygon_nms`` exactly JAX's (the same C++ engine,
  built by each package), the engine within 1e-9 of the numpy plain form;
- the port's splitter against ``tools/split/img_split.py``: the same patch
  names, byte-equal annotation files, pixel-equal images.
"""
import filecmp
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from r3det_tpu.datasets import dota as JD
from r3det_tpu.ops import polygon_geo as JP
from r3det_tpu_torch.datasets import dota as TD
from r3det_tpu_torch.datasets.image_io import imread
from r3det_tpu_torch.ops import polygon_geo as TP
from r3det_tpu_torch.tools import img_split, make_fake_dota

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = make_fake_dota.CLASSES


@pytest.fixture(scope='module')
def fake_dota(tmp_path_factory):
    """Six 700^2 scenes split at 512 with gap 128 (24 patches), by the
    port's maker."""
    root = tmp_path_factory.mktemp('fake_dota')
    raw, split = str(root / 'raw'), str(root / 'split')
    make_fake_dota.main(['--out', raw, '--split-out', split])
    return raw, split


def _datasets(split, **kw):
    args = (split + '/annfiles/', split + '/images/')
    kw = dict(filter_empty=False, classes=CLASSES, **kw)
    return JD.DOTADataset(*args, **kw), TD.DOTADataset(*args, **kw)


@pytest.mark.parametrize('version', ['v1', 'v2', 'v3'])
def test_dataset_matches_jax(fake_dota, version):
    jds, tds = _datasets(fake_dota[1], version=version)
    assert len(tds) == len(jds) == 24
    for a, b in zip(jds.data_infos, tds.data_infos):
        assert a['id'] == b['id'] and a['filename'] == b['filename']
        np.testing.assert_array_equal(a['ann']['labels'], b['ann']['labels'])
        np.testing.assert_array_equal(a['ann']['polygons'],
                                      b['ann']['polygons'])
        ab, bb = a['ann']['bboxes'], b['ann']['bboxes']
        assert ab.shape == bb.shape
        np.testing.assert_allclose(bb[:, :4], ab[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(bb[:, 4], ab[:, 4], rtol=0, atol=1e-5)
    assert sum(len(d['ann']['labels']) for d in tds.data_infos) > 0


def test_get_sample_matches_jax(fake_dota):
    jds, tds = _datasets(fake_dota[1])
    for i in (0, 5, len(tds) - 1):
        a, b = jds.get_sample(i), tds.get_sample(i)
        np.testing.assert_array_equal(b['img'], a['img'])
        assert b['img_shape'] == a['img_shape'] and b['img_id'] == a['img_id']
        np.testing.assert_array_equal(b['gt_labels'], a['gt_labels'])


def test_test_mode_globs_images(fake_dota, tmp_path):
    split = fake_dota[1]
    jds = JD.DOTADataset(str(tmp_path) + '/', split + '/images/',
                         test_mode=True)
    tds = TD.DOTADataset(str(tmp_path) + '/', split + '/images/',
                         test_mode=True)
    assert [d['id'] for d in tds.data_infos] == \
        [d['id'] for d in jds.data_infos] and len(tds) == 24


def _results(ds, seed, n_fp=4):
    """Per-patch per-class detections: each gt jittered (score in 0.3-1)
    plus n_fp random boxes an image, labels and scores from the seed."""
    rng = np.random.RandomState(seed)
    out = []
    for info in ds.data_infos:
        b, lbl = info['ann']['bboxes'], info['ann']['labels']
        dets = np.concatenate([
            b + rng.normal(0, [2, 2, 2, 2, 0.05], b.shape),
            np.stack([rng.uniform(0, 512, n_fp), rng.uniform(0, 512, n_fp),
                      rng.uniform(10, 80, n_fp), rng.uniform(10, 40, n_fp),
                      rng.uniform(-1.5, 0, n_fp)], -1)]).astype(np.float32)
        labels = np.concatenate([lbl, rng.randint(0, len(CLASSES), n_fp)])
        scores = rng.uniform(0.3, 1.0, len(dets)).astype(np.float32)
        scored = np.concatenate([dets, scores[:, None]], -1)
        out.append([scored[labels == c] for c in range(len(CLASSES))])
    return out


@pytest.mark.parametrize('use_07_metric', [False, True])
@pytest.mark.parametrize('version', ['v1', 'v3'])
def test_eval_rbbox_map_matches_jax(fake_dota, version, use_07_metric):
    jds, tds = _datasets(fake_dota[1], version=version)
    res = _results(tds, seed=1)
    want = jds.evaluate(res, use_07_metric=use_07_metric, logger=None,
                        nproc=1)
    got = tds.evaluate(res, use_07_metric=use_07_metric, logger=None,
                       nproc=1)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert 0 < got['mAP'] < 1


def test_results_do_not_depend_on_nproc(fake_dota):
    _, tds = _datasets(fake_dota[1])
    res = _results(tds, seed=2)
    assert tds.evaluate(res, logger=None, nproc=1) == \
        tds.evaluate(res, logger=None, nproc=4)
    ids1, m1 = tds.merge_det(res, nproc=1)
    ids4, m4 = tds.merge_det(res, nproc=4)
    assert ids1 == ids4
    for a, b in zip(m1, m4):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_merge_det_matches_jax(fake_dota):
    jds, tds = _datasets(fake_dota[1])
    res = _results(tds, seed=3, n_fp=12)
    jids, jm = jds.merge_det(res, nproc=1)
    tids, tm = tds.merge_det(res, nproc=1)
    assert tids == jids and len(tids) == 6
    kept = 0
    for a, b in zip(jm, tm):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
            kept += len(y)
    # translated back to the scenes and deduplicated across the overlaps
    assert 0 < kept < sum(len(c) for r in res for c in r)


def test_format_results_matches_jax(fake_dota, tmp_path):
    jds, tds = _datasets(fake_dota[1])
    res = _results(tds, seed=4)
    jzip = jds.format_results(res, str(tmp_path / 'jax'))
    tzip = tds.format_results(res, str(tmp_path / 'port'))
    names = [f'Task1_{c}.txt' for c in CLASSES]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / 'jax', tmp_path / 'port', names, shallow=False)
    assert match == names and not mismatch and not errors
    assert os.path.getsize(tzip) > 0 and os.path.basename(tzip) == \
        os.path.basename(jzip)
    assert os.path.getsize(tmp_path / 'port' / names[0]) > 0


def _polys(rng, n):
    r = [((rng.uniform(0, 300), rng.uniform(0, 300)),
          (rng.uniform(5, 120), rng.uniform(5, 120)),
          rng.uniform(-180, 180)) for _ in range(n)]
    return np.stack([cv2.boxPoints(x).reshape(-1) for x in r]).astype(
        np.float64)


def test_polygon_iou_and_nms_match_jax():
    rng = np.random.RandomState(5)
    p1, p2 = _polys(rng, 60), _polys(rng, 45)
    p2[:10] = p1[:10] + rng.normal(0, 3, (10, 8))
    iou = TP.polygon_iou(p1, p2)
    np.testing.assert_array_equal(iou, JP.polygon_iou(p1, p2))
    np.testing.assert_allclose(iou, TP._polygon_iou_np(p1, p2), rtol=0,
                               atol=1e-9)
    assert iou.max() > 0.5 and TP.polygon_iou(p1[:0], p2).shape == (0, 45)
    scored = np.concatenate([np.concatenate([p1, p2]),
                             rng.uniform(0, 1, (105, 1))], -1)
    for thr in (0.1, 0.5):
        keep = TP.polygon_nms(scored, thr)
        np.testing.assert_array_equal(keep, JP.polygon_nms(scored, thr))
        assert 0 < len(keep) < len(scored)
    assert TP.polygon_nms(scored[:0], 0.1).shape == (0,)


def test_img_split_matches_jax_tool(fake_dota, tmp_path):
    raw = fake_dota[0]
    args = ['--img-dirs', raw + '/images', '--ann-dirs', raw + '/labelTxt',
            '--sizes', '512', '--gaps', '200', '--rates', '1.0', '0.5',
            '--img-rate-thr', '0.6']
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'tools/split/img_split.py'),
         *args, '--save-dir', str(tmp_path / 'jax')],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert img_split.main(args + ['--save-dir', str(tmp_path / 'port')]) > 0
    for sub in ('annfiles', 'images'):
        assert sorted(os.listdir(tmp_path / 'port' / sub)) == \
            sorted(os.listdir(tmp_path / 'jax' / sub))
    names = sorted(os.listdir(tmp_path / 'jax' / 'annfiles'))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / 'jax' / 'annfiles', tmp_path / 'port' / 'annfiles', names,
        shallow=False)
    assert match == names and not mismatch and not errors
    for name in sorted(os.listdir(tmp_path / 'jax' / 'images')):
        np.testing.assert_array_equal(
            imread(str(tmp_path / 'port' / 'images' / name)),
            cv2.imread(str(tmp_path / 'jax' / 'images' / name)))
