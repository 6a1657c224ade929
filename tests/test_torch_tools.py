"""The port's analysis tools against the JAX package's, on the CPU.

- ``print_config`` prints the JAX tool's text (the merged config dict and
  the derived ``DetectorConfig``) for every shipped config;
- ``get_flops`` counts JAX's parameters exactly, and its FLOPs equal an
  independent count: every ``torch.conv2d`` call of the same forward,
  2 * (output elements) * (input channels / groups) * kh * kw;
- ``analyze_logs cal_train_time`` prints the JAX tool's throughput line on
  the same log, then the losses' and the validation records' summaries;
- ``benchmark`` prints its line on the CPU at a tiny size, in inference,
  forward-only and train modes.
"""
import contextlib
import glob
import importlib.util
import io
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from r3det_tpu.utils.builder import build_from_config as j_build
from r3det_tpu.utils.config import Config as JConfig
from r3det_tpu_torch.tools import analyze_logs, benchmark, get_flops
from r3det_tpu_torch.tools import print_config
from r3det_tpu_torch.utils.builder import build_from_config as t_build
from r3det_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', '**', '*.py'), recursive=True)
    if '_base_' not in p)
DEBUG_CONFIG = 'configs/debug/r3det_tiny_fake_dota.py'
TINY = ['--cfg-options', 'model.backbone.depth=10',
        'model.bbox_head.feat_channels=32']


def _jax_tool(rel):
    """A module of the JAX package's ``tools/`` tree, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        'jax_' + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize('path', CONFIGS)
def test_print_config_prints_the_jax_tools_text(path, monkeypatch):
    tool = _jax_tool('tools/misc/print_config.py')
    argv = [path, '--cfg-options', 'optimizer.lr=0.5']
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, 'argv', ['print_config.py', *argv])
    want = _stdout(tool.main)
    got = _stdout(print_config.main, argv)
    assert 'Derived DetectorConfig:' in got and "'lr': 0.5" in got
    assert got == want


class _ConvCount(TorchFunctionMode):
    """FLOPs of every ``torch.conv2d`` call, from its shapes."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.conv2d, torch.nn.functional.conv2d):
            w = args[1] if len(args) > 1 else kwargs['weight']
            self.flops += 2 * out.numel() * w.shape[1] * w.shape[2] * \
                w.shape[3]
        return out


@pytest.mark.parametrize('path', ['configs/r3det/r3det_r50_fpn_1x_dota_v1.py',
                                  'configs/rretinanet/'
                                  'rretinanet_obb_r50_fpn_1x_dota_v1.py'])
def test_get_flops_counts_jax_params_and_the_convolutions(path):
    cfg = os.path.join(ROOT, path)
    jmodel, _ = j_build(JConfig.fromfile(cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    want_params = sum(int(np.prod(s.shape)) for s in
                      jax.tree_util.tree_leaves(shapes['params']))
    model, _ = t_build(TConfig.fromfile(cfg), dtype=torch.float32,
                       device='cpu')
    n_params, flops = get_flops.count(model, (64, 96))
    assert n_params == want_params
    counter = _ConvCount()
    with torch.no_grad(), counter:
        model(torch.zeros(1, 64, 96, 3))
    assert flops == counter.flops > 0
    assert model.kernels                    # the detector's switch kept


def test_get_flops_cli_prints_its_lines():
    out = _stdout(get_flops.main, [DEBUG_CONFIG, '--shape', '64',
                                   '--device', 'cpu', *TINY])
    lines = out.splitlines()
    assert lines[0] == 'input shape: (1, 64, 64, 3)'
    assert re.fullmatch(r'params: \d+\.\d\d M', lines[1])
    assert re.match(r'flops:  \d+\.\d\d GFLOPs \(FlopCounterMode', lines[2])


def test_analyze_logs_gives_the_jax_tools_statistics(tmp_path):
    log = tmp_path / 'train_log.jsonl'
    recs = [dict(step=i, imgs_per_sec=30.0 + i * 1.5, lr=1e-3,
                 **{'s0.loss_cls': 1.0 / i, 'total': 2.0 / i + 0.1})
            for i in range(1, 6)]
    recs.insert(3, dict(step=3, mode='val', mAP=0.25))
    log.write_text('\n'.join(json.dumps(r) for r in recs) + '\n')
    tool = _jax_tool('tools/analysis_tools/analyze_logs.py')
    args = analyze_logs.parse_args(['cal_train_time', str(log)])
    want = _stdout(tool.cmd_time, args)
    got = _stdout(analyze_logs.cmd_time, args).splitlines()
    assert got[0] == want.strip()
    assert got[1:] == [
        '  s0.loss_cls: first 1.0000  last 0.2000  min 0.2000  mean 0.4567',
        '  total: first 2.1000  last 0.5000  min 0.5000  mean 1.0133',
        '  val @ step 3: mAP=0.2500']
    empty = tmp_path / 'empty.jsonl'
    empty.write_text(json.dumps(dict(step=1, mode='val', mAP=0.0)) + '\n')
    args = analyze_logs.parse_args(['cal_train_time', str(empty)])
    assert _stdout(analyze_logs.cmd_time, args) == \
        _stdout(tool.cmd_time, args)


@pytest.mark.parametrize('mode', ['infer', 'forward-only', 'train'])
def test_benchmark_prints_its_line_on_the_cpu(mode):
    size = '128' if mode == 'train' else '64'
    argv = [DEBUG_CONFIG, '--device', 'cpu', '--img-size', size,
            '--batch-size', '2', '--max-iter', '2', '--warmup', '1', *TINY]
    if mode == 'train':
        argv += ['--mode', 'train']
    elif mode == 'forward-only':
        argv += ['--forward-only']
    lines = _stdout(benchmark.main, argv).splitlines()
    assert lines[0] == 'cpu'
    unit = 'ms/step' if mode == 'train' else 'ms/iter'
    prefix = 'train: ' if mode == 'train' else ''
    assert re.fullmatch(
        rf'{prefix}\d+\.\d\d img/s \(\d+\.\d {unit}, batch 2, '
        rf'{size}x{size}\)', lines[-1]), lines[-1]
