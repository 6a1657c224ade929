"""Tiny versions of the benchmark's cells for CPU tests: the shipped
configurations cut to ResNet-10 with 32-channel heads, float32, and 128^2
images, in a manifest of their own under a temporary directory."""
import json
import shutil
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(PB.parent))

TINY = dict(backbone_depth=10, feat_channels=32, compute_dtype='float32')


def tiny_config(name):
    cfg = json.loads((PB / 'configs' / f'{name}.json').read_text())
    cfg.update(TINY)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


def make_tiny(root, limits=None):
    """A manifest with tiny cells ``tiny_r3det.serve``,
    ``tiny_rr.sparse`` and ``tiny_r3det.train`` under ``root``; the
    metric readers are the benchmark's own."""
    from portbench.bench.manifest import Manifest
    root = Path(root)
    for d in ('configs', 'traffic', 'limits'):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(PB / 'metrics', root / 'metrics', dirs_exist_ok=True)
    for name, src in (('tiny_r3det', 'r3det_r50'),
                      ('tiny_rr', 'rretinanet_obb_r50')):
        (root / 'configs' / f'{name}.json').write_text(
            json.dumps(tiny_config(src)))
    serve = dict(mode='serve', batch=2, size=128, pool=2,
                 image={'low': -2.0, 'high': 2.0}, calibration_images=2,
                 trace_steps=2)
    traffic = {
        'serve': dict(serve, shape=[
            {'layer': 'bbox_head.retina_cls'},
            {'layer': 'refine_head_0.retina_cls', 'live': 150}]),
        'sparse': dict(serve, shape=[
            {'layer': 'bbox_head.retina_cls', 'live': 50}]),
        'train': dict(mode='train', batch=2, size=128, pool=2, max_gt=8,
                      objects=[2, 4, 6, 8], check_steps=3, trace_steps=2),
    }
    for name, t in traffic.items():
        (root / 'traffic' / f'{name}.json').write_text(json.dumps(t))
    cells = [('tiny_r3det.serve', 'tiny_r3det', 'serve'),
             ('tiny_rr.sparse', 'tiny_rr', 'sparse'),
             ('tiny_r3det.train', 'tiny_r3det', 'train')]
    real = {'serve': 'r3det_r50.serve_dense',
            'sparse': 'rretinanet_obb_r50.serve_sparse',
            'train': 'r3det_r50.train'}
    for cell, _, traffic_name in cells:
        lim = limits if limits is not None else json.loads(
            (PB / 'limits' / f'{real[traffic_name]}.json').read_text())
        (root / 'limits' / f'{cell}.json').write_text(json.dumps(lim))
    serve_cells = ['tiny_r3det.serve', 'tiny_rr.sparse']
    bench = {
        'configs': [{'name': n, 'file': f'configs/{n}.json'}
                    for n in ('tiny_r3det', 'tiny_rr')],
        'workloads': [{'name': c, 'config': cf, 'traffic': t, 'chips': 1}
                      for c, cf, t in cells],
        'end_to_end': [
            {'name': 'patches_per_s', 'unit': 'patches/s',
             'workloads': serve_cells},
            {'name': 'train_images_per_s', 'unit': 'images/s',
             'workloads': ['tiny_r3det.train']},
            {'name': 'setup_s', 'unit': 's'}],
        'per_layer': [{'name': 'serve_mfu', 'unit': '%',
                       'workloads': serve_cells}],
    }
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return Manifest(root / 'BENCHMARK.json', base=root)


def run_cell(man, cell, seed=1234567890123, seconds=0.3):
    import time

    import torch

    from portbench.bench.cli import execute
    torch.manual_seed(0)
    return execute(man, man.cell(cell), seed, seconds, 0,
                   torch.device('cpu'), time.perf_counter())


@pytest.fixture
def tiny(tmp_path):
    import torch
    torch.set_num_threads(2)
    return make_tiny(tmp_path)
