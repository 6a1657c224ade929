"""The port's config, builder, eval loop and test CLI against the JAX
package's.

- ``Config`` equals JAX's on every file under ``configs/`` (``_base_``
  merging, ``merge_from_options``) and on a ``_delete_`` override;
- ``detector_config_from_dict`` / ``build_from_config`` give the same
  fields, warnings and kernel flags on every config and on dicts that
  trigger each warning; the build options the port does not take raise;
- the tiny f32 R3Det of ``tests/test_detector.py`` (the weights of
  ``test_torch_detector.py``: the same flax variables through
  ``from_flax``) through JAX's ``evaluate_dataset`` and the port's, on a
  fake-DOTA split resized to 64^2: per image and class the same number of
  detections, within ``test_torch_detector.py``'s f32 tolerance (rtol
  1e-4, atol 1e-3), and the same mAP;
- ``python -m r3det_tpu_torch.tools.test --device cpu`` end to end on the
  debug config shrunk with ``--cfg-options`` and ``--img-size``, with
  ``--eval mAP`` and ``--format-only``; it raises without a card by
  default; it evaluates a checkpoint's weights;
- every module of the port, the data-parallel module and the analysis
  tools among them, imports with jax, r3det_tpu, cv2, PIL, torchvision
  and matplotlib blocked.
"""
import glob
import os
import pickle
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.datasets import dota as JD
from r3det_tpu.models import detectors as J
from r3det_tpu.utils import builder as JB
from r3det_tpu.utils.config import Config as JConfig
from r3det_tpu.utils.eval_loop import evaluate_dataset as j_evaluate
from r3det_tpu_torch.datasets import dota as TD
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.tools import make_fake_dota
from r3det_tpu_torch.tools import test as test_cli
from r3det_tpu_torch.utils import builder as TB
from r3det_tpu_torch.utils.config import Config as TConfig
from r3det_tpu_torch.utils.convert import from_flax
from r3det_tpu_torch.utils.eval_loop import evaluate_dataset as t_evaluate

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', '**', '*.py'), recursive=True))
DEBUG_CONFIG = 'configs/debug/r3det_tiny_fake_dota.py'
CLASSES = make_fake_dota.CLASSES


@pytest.mark.parametrize('path', CONFIGS)
def test_config_matches_jax(path):
    opts = {'model.test_cfg.nms.iou_thr': '0.2', 'data.samples_per_gpu': '2',
            'new.key': 'text'}
    want = JConfig.fromfile(os.path.join(ROOT, path))
    got = TConfig.fromfile(os.path.join(ROOT, path))
    assert got.to_dict() == want.to_dict()
    want.merge_from_options(dict(opts))
    got.merge_from_options(dict(opts))
    assert got.to_dict() == want.to_dict()


def test_config_delete_override_matches_jax(tmp_path):
    (tmp_path / 'base.py').write_text(
        "model = dict(a=1, b=dict(c=2, d=3))\nlst = [1, 2]\n")
    (tmp_path / 'child.py').write_text(
        "_base_ = './base.py'\n"
        "model = dict(b=dict(_delete_=True, e=4), f=5)\nlst = [3]\n")
    want = JConfig.fromfile(str(tmp_path / 'child.py')).to_dict()
    got = TConfig.fromfile(str(tmp_path / 'child.py')).to_dict()
    assert got == want == {'model': {'a': 1, 'b': {'e': 4}, 'f': 5},
                           'lst': [3]}


def _fields(nt):
    """NamedTuples (nested, in tuples) -> plain dicts and lists."""
    if hasattr(nt, '_asdict'):
        return {k: _fields(v) for k, v in nt._asdict().items()}
    if isinstance(nt, (tuple, list)):
        return [_fields(v) for v in nt]
    return nt


def _build(module, cfg, monkeypatch, **kw):
    """``module.build_from_config`` with its build_detector captured:
    returns (DetectorConfig fields, build kwargs, warnings)."""
    seen = {}

    def capture(det_cfg, **kwargs):
        seen.update(kwargs)
        return 'model'

    monkeypatch.setattr(module, 'build_detector', capture)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        _, det_cfg = module.build_from_config(cfg, **kw)
    for k in ('dtype', 'device'):
        seen.pop(k, None)
    return _fields(det_cfg), seen, [str(x.message) for x in w]


# config overrides: none, the kernel flags, int8 serving
FLAG_OPTIONS = [
    {},
    {'model.stem_fused_kernel': True, 'test_cfg.fused_blocks': 1,
     'model.stem_pool_kernel': False, 'model.int8_act': True},
    {'model.quantize_int8': 'static', 'test_cfg.quantize_head_int8': True,
     'test_cfg.nms_candidates': 3000, 'test_cfg.nms.iou_thr': 0.3},
]


@pytest.mark.parametrize('options', range(len(FLAG_OPTIONS)))
@pytest.mark.parametrize('path', [p for p in CONFIGS if '_base_' not in p])
def test_builder_matches_jax(path, options, monkeypatch):
    cfg = JConfig.fromfile(os.path.join(ROOT, path))
    cfg.merge_from_options(dict(FLAG_OPTIONS[options]))
    want = _build(JB, cfg, monkeypatch)
    got = _build(TB, cfg, monkeypatch, device='cpu')
    assert got == want


WARN_MODELS = [
    # an unknown sampler, an unknown nms type, an unknown cls loss
    dict(type='RetinaNet', bbox_head=dict(loss_cls=dict(type='GHMC'))),
    dict(type='R3Det', num_refine_stages=1, bbox_head=dict(
        loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=True))),
]
WARN_TRAIN = [dict(sampler=dict(type='OHEMSampler')),
              dict(sampler=dict(type='RRandomSampler', num=128),
                   s0=dict(sampler=dict(type='RRandomSampler', num=64)))]
WARN_TEST = [dict(nms=dict(type='rotated')), dict(nms=dict(type='v3'))]


@pytest.mark.parametrize('case', range(2))
def test_builder_warnings_match_jax(case):
    args = (WARN_MODELS[case], WARN_TRAIN[case], WARN_TEST[case])
    out = []
    for fn in (JB.detector_config_from_dict, TB.detector_config_from_dict):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            det_cfg = fn(*args)
        out.append((_fields(det_cfg), [str(x.message) for x in w]))
    assert out[0] == out[1] and out[0][1]


@pytest.mark.parametrize('where,key,value', [
    ('model', 'frm_fuse_convs', True),
    ('test_cfg', 'frm_sample_kernel', True),
    ('test_cfg', 'approx_topk', True),
])
def test_unported_build_options_raise(where, key, value):
    """The FRM build options build a model that takes them; the TPU-only
    ``approx_topk`` still raises."""
    cfg = TConfig.fromfile(os.path.join(ROOT, DEBUG_CONFIG))
    cfg.merge_from_options({f'{where}.{key}': value,
                            'model.backbone.depth': 10,
                            'model.bbox_head.feat_channels': 32})
    if key == 'approx_topk':
        with pytest.raises(NotImplementedError, match=f"{key}.*Not to port"):
            TB.build_from_config(cfg, dtype=torch.float32, device='cpu')
        return
    model, _ = TB.build_from_config(cfg, dtype=torch.float32, device='cpu')
    attr = {'frm_fuse_convs': 'fuse_convs',
            'frm_sample_kernel': 'sample_kernel'}[key]
    assert getattr(model.frm_0, attr) == value


def test_builder_builds_the_debug_config_on_cpu():
    cfg = TConfig.fromfile(os.path.join(ROOT, DEBUG_CONFIG))
    cfg.merge_from_options({'model.backbone.depth': 10,
                            'model.bbox_head.feat_channels': 32,
                            'model.frm_fuse_convs': False})
    model, det_cfg = TB.build_from_config(cfg, dtype=torch.float32,
                                          device='cpu')
    assert isinstance(model, T.R3Det) and det_cfg.num_classes == 3
    assert next(model.parameters()).device.type == 'cpu'


# ---------------------------------------------------------------------------
# The eval loop: JAX's against the port's on one tiny f32 R3Det
# ---------------------------------------------------------------------------

FEATMAP_SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
J_CFG = J.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=J.TestCfg(nms_pre=64, max_per_img=16))
T_CFG = T.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, test=T.TestCfg(nms_pre=64, max_per_img=16))


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake_dota')
    make_fake_dota.main(['--out', str(root / 'raw'), '--split-out',
                         str(root / 'split'), '--num-images', '2'])
    return str(root / 'split')


def test_evaluate_dataset_matches_jax(split):
    args = (split + '/annfiles/', split + '/images/')
    jds = JD.DOTADataset(*args, filter_empty=False, classes=CLASSES)
    tds = TD.DOTADataset(*args, filter_empty=False, classes=CLASSES)
    assert len(tds) == 8
    model = J.build_detector(J_CFG, dtype=jnp.float32)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    for head in ('bbox_head', 'refine_head_0'):
        v['params'][head]['retina_cls']['kernel'] *= 100
        v['params'][head]['retina_reg']['kernel'] *= 30
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params']['frm_0'][name]['kernel'] *= 30
    v['params']['refine_head_0']['retina_cls']['bias'] += 4.0
    want = j_evaluate(v, model, J_CFG, jds, img_size=64, batch_size=3)
    tmodel = T.build_detector(T_CFG, dtype=torch.float32, device='cpu')
    tmodel.load_state_dict(from_flax(v), strict=True)
    got = t_evaluate(tmodel, T_CFG, tds, img_size=64, batch_size=3)
    assert len(got) == len(want) == 8
    for gi, wi in zip(got, want):
        assert len(gi) == len(wi) == 3
        for g, w in zip(gi, wi):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    assert sum(len(c) for r in got for c in r) > 8
    assert tds.evaluate(got, logger=None, nproc=1) == \
        jds.evaluate(want, logger=None, nproc=1)


def test_evaluate_dataset_times_its_phases(split):
    tds = TD.DOTADataset(split + '/annfiles/', split + '/images/',
                         filter_empty=False, classes=CLASSES)
    tmodel = T.build_detector(T_CFG, dtype=torch.float32, device='cpu')
    times = {}
    calls = []
    res = t_evaluate(tmodel, T_CFG, tds, img_size=64, batch_size=5,
                     times=times, progress=lambda d, n: calls.append((d, n)))
    assert len(res) == 8 and set(times) == {'decode', 'transforms',
                                            'predict'}
    assert all(t > 0 for t in times.values())
    assert calls == [(5, 8), (8, 8)]


# ---------------------------------------------------------------------------
# The test CLI
# ---------------------------------------------------------------------------

def _cli_args(split):
    return ['--img-size', '64', '--batch-size', '4', '--cfg-options',
            f'data.test.ann_file={split}/annfiles/',
            f'data.test.img_prefix={split}/images/',
            'model.backbone.depth=10', 'model.bbox_head.feat_channels=32']


def test_test_cli_runs_on_cpu(split, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS='2', PYTHONPATH=ROOT)
    out = tmp_path / 'results.pkl'
    proc = subprocess.run(
        [sys.executable, '-m', 'r3det_tpu_torch.tools.test', DEBUG_CONFIG,
         '--device', 'cpu', '--eval', 'mAP', '--format-only',
         '--format-dir', str(tmp_path / 'sub'), '--out', str(out),
         '--seed', '1', *_cli_args(split)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "{'mAP':" in proc.stdout and '8 images' in proc.stdout
    with open(out, 'rb') as f:
        results = pickle.load(f)
    assert len(results) == 8 and all(len(r) == 3 for r in results)
    assert sorted(os.listdir(tmp_path / 'sub')) == sorted(
        [f'Task1_{c}.txt' for c in CLASSES] + ['submission.zip'])


def test_test_cli_raises_without_a_card_and_on_a_checkpoint(split):
    """No card by default: it raises. A checkpoint that is not there: it
    raises (the test CLI reads checkpoints, below)."""
    with pytest.raises(FileNotFoundError, match='ckpt_dir'):
        test_cli.main([DEBUG_CONFIG, 'ckpt_dir', '--device', 'cpu',
                       *_cli_args(split)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            test_cli.main([os.path.join(ROOT, DEBUG_CONFIG),
                           *_cli_args(split)])


def test_test_cli_evaluates_a_checkpoint(split, tmp_path):
    """A checkpoint (``save_checkpoint``'s, and its published form) of
    weights from seed 3 with the refine cls bias raised, so that they
    detect: the CLI's results on it equal ``evaluate_dataset``'s on the
    model saved, exactly; the CLI's seeded weights give others."""
    from r3det_tpu_torch.parallel.train import make_optimizer
    from r3det_tpu_torch.utils.checkpoint import (publish_checkpoint,
                                                  save_checkpoint)
    from r3det_tpu_torch.utils.convert import seeded_state_dict
    cfg = TConfig.fromfile(os.path.join(ROOT, DEBUG_CONFIG))
    cfg.merge_from_options({'model.backbone.depth': 10,
                            'model.bbox_head.feat_channels': 32})
    model, det_cfg = TB.build_from_config(cfg, dtype=torch.float32,
                                          device='cpu')
    model.load_state_dict(seeded_state_dict(model, 3))
    with torch.no_grad():
        model.refine_head_0.retina_cls.bias.fill_(4.0)
    ckpt = save_checkpoint(str(tmp_path / 'ckpt'), 5, model,
                           make_optimizer(model.parameters()))
    published = publish_checkpoint(ckpt, str(tmp_path / 'pub.pt'))

    def run(*extra):
        out = tmp_path / f'r{len(os.listdir(tmp_path))}.pkl'
        test_cli.main([DEBUG_CONFIG, *extra, '--device', 'cpu', '--out',
                       str(out), *_cli_args(split)])
        with open(out, 'rb') as f:
            return pickle.load(f)

    def same(a, b):
        return all(np.array_equal(x, y) for ra, rb in zip(a, b)
                   for x, y in zip(ra, rb))

    tds = TD.DOTADataset(split + '/annfiles/', split + '/images/',
                         filter_empty=False, classes=CLASSES)
    want = t_evaluate(model, det_cfg, tds, img_size=64, batch_size=4)
    assert sum(len(c) for r in want for c in r) > 0
    assert same(run(ckpt), want)
    assert same(run(published), want)
    assert not same(run('--seed', '3'), want)


def test_pipeline_image_size_follows_the_config():
    cfg = TConfig.fromfile(os.path.join(ROOT, DEBUG_CONFIG))
    assert test_cli.pipeline_image_size(cfg.data.test) == (1024, 1024)
    assert test_cli.pipeline_image_size(cfg.data.test, 64) == (64, 64)
    assert test_cli.pipeline_image_size(TConfig({})) == (1024, 1024)


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------

IMPORT_CHECK = r'''
import importlib, importlib.abc, os, pkgutil, sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'r3det_tpu', 'cv2', 'PIL',
           'torchvision', 'matplotlib')
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'blocked: {name}')
        return None
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import r3det_tpu_torch
mods = ['r3det_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(r3det_tpu_torch.__path__,
                                          'r3det_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
for m in ('parallel.dist', 'tools.benchmark', 'tools.get_flops',
          'tools.print_config', 'tools.analyze_logs'):
    assert 'r3det_tpu_torch.' + m in mods, m
import chip_smoke
bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]
assert not bad, bad
print(len(mods))
'''


def test_port_imports_no_jax_opencv_or_pil():
    proc = subprocess.run([sys.executable, '-c', IMPORT_CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40
