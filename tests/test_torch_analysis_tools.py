"""The port's ``analyze_results`` and ``browse_dataset`` against the JAX
package's tools, on the CPU.

Both packages' tools run on one ``make_fake_dota`` split (2 scenes, 8
patches) through a config that inherits the 15-class R3Det* config (the
JAX tools take DOTA-v1.0's classes whatever the config says, so the
config gives none) and points ``data.train`` / ``data.val`` at the split.
The JAX tools run as their scripts in subprocesses, side by side with
the port's, which run in this process with their captions recorded.

- ``analyze_results --topk 2`` on a seeded results pickle (each patch's
  ground truth jittered and scored, some dropped, false positives added,
  one patch with no detections): the same ``bad/`` and ``good/`` file
  names, which carry each image's mAP (``{mAP:.3f}_{id}.png``), and the
  same pixels outside the caption boxes.
- ``browse_dataset --limit 4 --device cpu`` with a train pipeline that
  draws nothing at random (``RResize`` to 256, ``RRandomFlip`` with
  ``flip_ratio=1.0``, vertical, then ``Normalize`` and ``Pad``, which the
  tools drop): the same file names and the same pixels outside the
  caption boxes.
"""
import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest

from r3det_tpu_torch.datasets.dota import DOTADataset
from r3det_tpu_torch.tools import analyze_results, browse_dataset
from r3det_tpu_torch.tools import make_fake_dota

from test_torch_visualization import caption_mask, record_captions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
CONFIG = '''
_base_ = [{base!r}]
data = dict(
    train=dict(
        ann_file={ann!r}, img_prefix={img!r},
        pipeline=[
            dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='RResize', img_scale=(256, 256)),
            dict(type='RRandomFlip', flip_ratio=1.0, direction='vertical'),
            dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                 std=[58.395, 57.12, 57.375], to_rgb=True),
            dict(type='Pad', size_divisor=32),
        ]),
    val=dict(ann_file={ann!r}, img_prefix={img!r}))
'''


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp('analysis')
    make_fake_dota.main(['--out', str(root / 'raw'), '--split-out',
                         str(root / 'split'), '--num-images', '2'])
    cfg = root / 'config.py'
    cfg.write_text(CONFIG.format(
        base=os.path.join(ROOT, 'configs/r3det/'
                                'r3det_tiny_r50_fpn_1x_dota_v1.py'),
        ann=str(root / 'split' / 'annfiles') + '/',
        img=str(root / 'split' / 'images') + '/'))
    return root, str(cfg)


def fake_results(ds, seed=0):
    """Per patch, per DOTA-v1.0 class, (n, 6) detections: the patch's
    ground truth moved by up to 3 px and scored, a third dropped, a few
    false positives; the first patch gets none."""
    rng = np.random.RandomState(seed)
    results = []
    for i, info in enumerate(ds.data_infos):
        ann = info['ann']
        per_class = []
        for c in range(len(ds.CLASSES)):
            gt = ann['bboxes'][ann['labels'] == c]
            gt = gt[rng.uniform(size=len(gt)) > 1 / 3]
            fp = np.stack([rng.uniform(0, 512, 2), rng.uniform(0, 512, 2),
                           rng.uniform(20, 80, 2), rng.uniform(10, 40, 2),
                           rng.uniform(-1.5, 0, 2)], -1)[:rng.randint(3)]
            boxes = np.concatenate([gt, fp]) if len(gt) else fp
            boxes = boxes + np.concatenate(
                [rng.uniform(-3, 3, (len(boxes), 2)),
                 np.zeros((len(boxes), 3))], -1)
            dets = np.concatenate(
                [boxes, rng.uniform(0.2, 1.0, (len(boxes), 1))], -1)
            per_class.append(dets.astype(np.float32)[:0 if i == 0 else None])
        results.append(per_class)
    return results


def _jax_tool(script, *args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.Popen([sys.executable, os.path.join(ROOT, script),
                             *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f'{out}\n{err}'


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_outside_captions(jax_dir, port_dir, files):
    """Each PNG of the port equals the JAX tool's outside its captions'
    boxes; returns how many images were compared."""
    for name, captions in files.items():
        got = cv2.imread(name)
        want = cv2.imread(os.path.join(jax_dir,
                                       os.path.relpath(name, port_dir)))
        assert got is not None and want is not None, name
        outside = ~caption_mask(got.shape, captions)
        assert outside.mean() > 0.5, name
        assert np.array_equal(got[outside], want[outside]), name
    return len(files)


def test_analyze_results_matches_jax(split, tmp_path, monkeypatch):
    root, cfg = split
    ds = DOTADataset(str(root / 'split' / 'annfiles'), filter_empty=False)
    pkl = str(tmp_path / 'results.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(fake_results(ds), f)
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    proc = _jax_tool('tools/analysis_tools/analyze_results.py', cfg, pkl,
                     '--show-dir', jax_dir, '--topk', '2')
    _, files = record_captions(monkeypatch)
    analyze_results.main([cfg, pkl, '--show-dir', port_dir, '--topk', '2'])
    _finish(proc)
    names = _files(port_dir)
    assert names == _files(jax_dir)
    assert [n.split('/')[0] for n in names] == ['bad'] * 2 + ['good'] * 2
    maps = sorted(float(os.path.basename(n).split('_')[0]) for n in names)
    assert maps[0] == 0.0 and maps[-1] > 0.5, names
    assert _same_outside_captions(jax_dir, port_dir, files) == 4


def test_browse_dataset_matches_jax(split, tmp_path, monkeypatch):
    _, cfg = split
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    proc = _jax_tool('tools/misc/browse_dataset.py', cfg, '--output-dir',
                     jax_dir, '--limit', '4')
    _, files = record_captions(monkeypatch)
    browse_dataset.main([cfg, '--output-dir', port_dir, '--limit', '4',
                         '--device', 'cpu'])
    _finish(proc)
    assert _files(port_dir) == _files(jax_dir)
    assert len(_files(port_dir)) == 4
    for name in files:
        assert cv2.imread(name).shape[:2] in ((256, 256),)
    assert _same_outside_captions(jax_dir, port_dir, files) == 4
