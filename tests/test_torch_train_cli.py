"""A CPU rehearsal of the port's train CLI (``r3det_tpu_torch.tools.train``)
and ``tools/publish_model.py``.

The debug config (``configs/debug/r3det_tiny_fake_dota.py``: R3Det, 3
classes) cut to depth 10 and width 32, f32 on the CPU (``--device cpu``),
on a fake-DOTA split of 8 patches that the port's maker writes, each
resized to 128^2 (``--img-size 128``; at 64 the CLI's feature-map rule,
the canvas over the stride, gives P7 no cell, in both packages), batch 2.

- Resume: the CLI for 2 steps (the config's eval hook runs at the end),
  then resumed from its checkpoint to step 4;
  beside it the 2-step state kept in memory and stepped twice on the
  batches a new loader gives (the resumed run's loader starts a new epoch,
  as the JAX CLI's does): the parameters, momentum and update count bit
  for bit, the logged losses and LR equal; the log's keys are the JAX
  CLI's; the eval hook logs an mAP at each run's end.
- ``--synthetic`` trains; ``--pretrained-backbone`` loads a ``.npz`` the
  test writes (the frozen stem and stage 1 keep it, up to one step's
  weight decay); ``publish_model`` strips the optimizer and hashes the
  name; without a card the CLI and the loader raise unless asked for the
  CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from r3det_tpu_torch.datasets.loader import DetLoader
from r3det_tpu_torch.parallel.train import make_train_step
from r3det_tpu_torch.tools import make_fake_dota, publish_model, train
from r3det_tpu_torch.utils.builder import build_from_config
from r3det_tpu_torch.utils.checkpoint import convert_torch_resnet
from r3det_tpu_torch.utils.config import Config

torch.set_num_threads(2)

CONFIG = 'configs/debug/r3det_tiny_fake_dota.py'
SIZE = 128
LOG_KEYS = {'step', 'imgs_per_sec', 'lr', 's0.loss_cls', 's0.loss_bbox',
            'sr0.loss_cls', 'sr0.loss_bbox', 'total'}


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake_dota_cli')
    out = str(root / 'split')
    make_fake_dota.main(['--out', str(root / 'raw'), '--split-out', out,
                         '--num-images', '2'])
    return out


def _options(split):
    return [f'data.{s}.{k}={split}/{d}/' for s in ('train', 'val')
            for k, d in (('ann_file', 'annfiles'), ('img_prefix', 'images'))
            ] + ['data.samples_per_gpu=2', 'model.backbone.depth=10',
                 'model.bbox_head.feat_channels=32']


def _argv(split, work_dir, *extra):
    return [CONFIG, '--device', 'cpu', '--img-size', str(SIZE),
            '--log-interval', '1', '--work-dir', str(work_dir), *extra,
            '--cfg-options', *_options(split)]


def _log(work_dir):
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def two_steps(split, tmp_path_factory):
    work = tmp_path_factory.mktemp('two_steps')
    run = train.main(_argv(split, work, '--max-steps', '2'))
    return run, str(work)


def test_resume_equals_one_process(split, two_steps, tmp_path):
    run, work = two_steps
    ckpt = os.path.join(work, 'ckpt', 'step_2.pt')
    assert run['step'] == 2 and os.path.exists(ckpt)
    log = _log(work)
    assert [set(r) for r in log if 'mode' not in r] == [LOG_KEYS] * 2
    assert [r['step'] for r in log if 'mode' in r] == [2]   # the eval hook

    resumed = train.main(_argv(split, tmp_path, '--max-steps', '4',
                               '--resume-from', ckpt))
    assert resumed['step'] == 4
    assert resumed['metrics'] is not None and 'mAP' in resumed['metrics']
    log = _log(tmp_path)
    assert [r['step'] for r in log if 'mode' not in r] == [3, 4]
    assert [r['mode'] for r in log if 'mode' in r] == ['val']

    # the 2-step state, stepped on in this process on a fresh loader
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in _options(split)))
    _, det_cfg = build_from_config(cfg, dtype=torch.float32, device='cpu')
    loader, _, canvas = train.build_train_loader(cfg, det_cfg, 2, 0, 'cpu',
                                                 SIZE)
    model, opt = run['model'], run['optimizer']
    sizes = tuple((canvas[0] // s, canvas[1] // s) for s in det_cfg.strides)
    step = make_train_step(model, det_cfg, sizes, optimizer=opt,
                           device='cpu')
    it = iter(loader)
    want = [{k: float(v) for k, v in step(next(it)).items()}
            for _ in range(2)]
    it.close()

    got_model, got_opt = resumed['model'], resumed['optimizer']
    for (name, a), b in zip(got_model.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(got_opt.trace, opt.trace):
        assert torch.equal(a, b)
    assert got_opt.count == opt.count == 4
    for rec, w in zip(resumed['history'], want):
        assert {k: rec[k] for k in w} == w
        assert rec['lr'] == opt.lr_schedule(rec['step'])


def test_synthetic_trains(split, tmp_path):
    run = train.main(_argv(split, tmp_path, '--synthetic', '--max-steps',
                           '2'))
    assert run['step'] == 2 and run['canvas'] == (SIZE, SIZE)
    assert all(np.isfinite(r['total']) for r in run['history'])
    assert len(run['wait_s']) == len(run['iter_s']) == 2


def _torchvision_resnet10(model, seed):
    """A torchvision-style state dict with the shapes of the depth-10
    backbone of ``model``, from a numpy seed."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.backbone.state_dict().items():
        k = k.replace('_', '.', 1) if k.startswith('layer') else k
        k = k.replace('downsample_conv', 'downsample.0').replace(
            'downsample_bn', 'downsample.1')
        stem, leaf = k.rsplit('.', 1)
        if leaf == 'kernel':
            sd['conv1.weight'] = rng.normal(0, .1, (64, 3, 7, 7))
            continue
        name = {'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var'}.get(leaf, leaf)
        val = rng.uniform(.5, 1.5, v.shape) if leaf in ('scale', 'var') \
            else rng.normal(0, .05, v.shape)
        sd[f'{stem}.{name}'] = val
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_pretrained_backbone_npz(split, tmp_path):
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in _options(split)))
    probe, _ = build_from_config(cfg, dtype=torch.float32, device='cpu')
    sd = _torchvision_resnet10(probe, 3)
    np.savez(tmp_path / 'resnet10.npz', **sd)
    run = train.main(_argv(split, tmp_path / 'w', '--max-steps', '1',
                           '--pretrained-backbone',
                           str(tmp_path / 'resnet10.npz')))
    want = convert_torch_resnet(sd, 10)
    got = run['model'].backbone.state_dict()
    # the frozen stem and stage 1 take one step of weight decay alone
    for k in ('conv1.kernel', 'bn1.scale', 'layer1_0.conv2.weight'):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
    assert not torch.allclose(probe.backbone.state_dict()['conv1.kernel'],
                              want['conv1.kernel'])


def test_publish_model_strips_the_optimizer(two_steps, tmp_path):
    _, work = two_steps
    ckpt = os.path.join(work, 'ckpt', 'step_2.pt')
    out = publish_model.main([ckpt, str(tmp_path / 'r3det_fake.pt')])
    name = os.path.basename(out)
    assert name.startswith('r3det_fake-') and len(name) == len(
        'r3det_fake-') + 8 + len('.pt')
    payload = torch.load(out, weights_only=True)
    assert set(payload) == {'state_dict'}
    saved = torch.load(ckpt, weights_only=True)
    assert set(saved) == {'step', 'state_dict', 'trace', 'count'}
    assert set(payload['state_dict']) == set(saved['state_dict'])
    for k, v in saved['state_dict'].items():
        assert torch.equal(payload['state_dict'][k], v)


def test_cli_and_loader_raise_without_a_card(split, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = _argv(split, tmp_path, '--max-steps', '1')
    cuda = [a if a != 'cpu' else 'cuda' for a in argv]
    with pytest.raises(RuntimeError, match='no CUDA card'):
        train.main(cuda)
    default = argv[:1] + argv[3:]           # no --device: the card
    with pytest.raises(RuntimeError, match='no CUDA card'):
        train.main(default)
    assert not os.path.exists(tmp_path / 'train_log.jsonl')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        DetLoader([], None)
