"""The harness on the CPU at tiny sizes: the manifest, the traffic, the
metric arithmetic, the result line, the card check, the imports, and
``correct`` under the control and under planted faults."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import PB, run_cell

from portbench.bench import common, serve, trace, train
from portbench.bench.manifest import Manifest

RUN = str(PB / 'run.py')


def test_manifest_finds_every_file_by_name():
    man = Manifest()
    for cell in man.data['workloads']:
        cfg = man.config(cell['config'])
        assert cfg['name'] == cell['config']
        assert man.traffic(cell['traffic'])['mode'] in ('serve', 'train')
        assert man.limits(cell['name'])['numbers']
        assert man.end_to_end(cell['name'])
        assert man.per_layer(cell['name'])
        for m in man.per_layer(cell['name']):
            assert callable(man.reader(m))
    names = {m['name'] for m in man.data['end_to_end']}
    assert 'setup_s' in names


def test_new_files_and_entries_need_no_other_edit(tiny, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are
    picked up from their files and entries alone."""
    root = tmp_path
    cfg = json.loads((root / 'configs' / 'tiny_rr.json').read_text())
    cfg['num_classes'] = 3
    (root / 'configs' / 'tiny_rr3.json').write_text(json.dumps(cfg))
    t = json.loads((root / 'traffic' / 'sparse.json').read_text())
    t['batch'] = 1
    (root / 'traffic' / 'one.json').write_text(json.dumps(t))
    (root / 'metrics' / 'steps_seen.py').write_text(
        'def read(run):\n    return float(run["res"]["steps"])\n')
    (root / 'limits' / 'tiny_rr3.one.json').write_text(
        (root / 'limits' / 'tiny_rr.sparse.json').read_text())
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny_rr3',
                             'file': 'configs/tiny_rr3.json'})
    bench['workloads'].append({'name': 'tiny_rr3.one', 'config': 'tiny_rr3',
                               'traffic': 'one', 'chips': 1})
    bench['end_to_end'][0]['workloads'].append('tiny_rr3.one')
    bench['per_layer'].append({'name': 'steps_seen', 'unit': 'steps',
                               'workloads': ['tiny_rr3.one']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    man = Manifest(root / 'BENCHMARK.json', base=root)
    assert man.config('tiny_rr3')['num_classes'] == 3
    assert man.traffic(man.cell('tiny_rr3.one')['traffic'])['batch'] == 1
    m = [m for m in man.per_layer('tiny_rr3.one')
         if m['name'] == 'steps_seen'][0]
    assert man.reader(m)({'res': {'steps': 7}}) == 7.0
    out = run_cell(man, 'tiny_rr3.one')
    assert out['correct'] and out['metrics']['patches_per_s']['value'] > 0


def test_traffic_is_deterministic_in_the_seed():
    dev = torch.device('cpu')
    seed = 2 ** 31 + 12345
    g1 = torch.Generator().manual_seed(common.derive_seed(seed, 2))
    g2 = torch.Generator().manual_seed(common.derive_seed(seed, 2))
    spec = {'low': -2.0, 'high': 2.0}
    assert torch.equal(serve.images(g1, 2, 64, spec, dev),
                       serve.images(g2, 2, 64, spec, dev))
    t = dict(batch=2, size=128, pool=2, max_gt=8, objects=[2, 4, 6, 8])
    a = train.pool_batches(t, 15, seed, dev)
    b = train.pool_batches(t, 15, seed, dev)
    c = train.pool_batches(t, 15, seed + 1, dev)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]['image'], c[0]['image'])
    # every seed trains on the same object counts, in its own order
    for pool in (a, c):
        counts = sorted(int(n) for p in pool for n in p['gt_mask'].sum(1))
        assert counts == [2, 4, 6, 8]


def test_weights_are_deterministic_in_the_seed():
    from portbench.reference.model import Detector
    from conftest import tiny_config
    ref = Detector(tiny_config('r3det_r50'))
    a = common.seeded_state(ref, 77, torch.device('cpu'))
    b = common.seeded_state(ref, 77, torch.device('cpu'))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a['backbone.layer3_0.conv2.weight']
    assert float(w.std()) == pytest.approx((256 * 9) ** -0.5, rel=0.05)
    assert float(a['refine_head_0.cls_conv_0.weight'].std()) == \
        pytest.approx(0.01, rel=0.05)


@pytest.mark.parametrize('live', [60, 150])
def test_shaping_reaches_its_live_target(live):
    from conftest import tiny_config

    from portbench.reference import predict as rpred
    from portbench.reference.model import Detector
    cfg = tiny_config('r3det_r50')
    ref = Detector(cfg)
    state = common.seeded_state(ref, 3, torch.device('cpu'))
    g = torch.Generator().manual_seed(1)
    x = serve.images(g, 4, 128, {'low': -2.0, 'high': 2.0},
                     torch.device('cpu'))
    common.shape_cls(state, ref, cfg, x[:2], [
        {'layer': 'bbox_head.retina_cls'},
        {'layer': 'refine_head_0.retina_cls', 'live': live}])
    with torch.no_grad():
        out = ref(x)
    _, sel = rpred.predict(out, cfg, common.featmap_sizes(cfg, 128),
                           (128, 128))
    got = sorted(int(v) for v in sel[3])
    assert 0.6 * live < got[len(got) // 2] < 1.4 * live


def test_metric_arithmetic():
    lat = list(range(1, 101))
    assert common.quantile(lat, 0.95) == pytest.approx(95.05)
    assert common.quantile([5.0], 0.95) == 5.0
    iv = [(0, 2), (1, 3), (5, 6)]
    assert trace.union_length(iv) == 4
    assert trace.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert trace.subtract_length([(0, 10)], [(2, 3), (2.5, 4)]) == 8
    # idle share and a roofline share as the readers take them
    tr = trace.DeviceTrace.__new__(trace.DeviceTrace)
    tr.device = [(0.0, 2e6, 'k'), (1e6, 3e6, 'rotated_iou_kernel<1>'),
                 (5e6, 6e6, 'k')]
    tr.start, tr.end, tr.host, tr.step_ranges = 0.0, 8e6, [], [(0, 8e6)]
    man = Manifest()
    run = {'trace': tr, 'steps': 1, 'kernel_work': [([100], 10)]}
    idle = man.reader({'name': 'idle_share.serve'})(run)
    assert idle == pytest.approx(50.0)
    from portbench.work import kernels
    share = man.reader({'name': 'iou_roofline.serve'})(run)
    least = kernels.bound(*kernels.iou_work([100], 10), 'f32')[0]
    assert share == pytest.approx(100 * least / 2.0)
    rate = {'res': {'steps': 10, 'window_s': 2.0}, 'traffic': {
        'batch': 8, 'size': 1024}, 'cfg': json.loads(
            (PB / 'configs' / 'r3det_r50.json').read_text())}
    mfu = man.reader({'name': 'serve_mfu'})(rate)
    assert mfu == pytest.approx(100 * 669.693247488e9 * 40 / 989e12)
    p95 = man.reader({'name': 'predict_ms_p95.serve'})(
        {'res': {'latency_ms': lat}})
    assert p95 == pytest.approx(95.05)
    assert man.reader({'name': 'frm_ms.serve'})(
        {'spans': {'backbone': 1.0}, 'steps': 1}) is None


def test_result_line_keys(tiny):
    out = run_cell(tiny, 'tiny_r3det.serve')
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert set(out['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert set(out['metrics']) == {'patches_per_s', 'setup_s'}
    assert all(set(m) == {'value', 'unit'} for m in out['metrics'].values())
    assert out['correct'] and out['failed'] == 0 and out['attempted'] > 0
    assert set(out['checks']) == set(
        tiny.limits('tiny_r3det.serve')['numbers'])


def test_without_a_card_the_run_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, RUN, '--workload',
                        'r3det_r50.serve_dense', '--seed', '1', '--seconds',
                        '1', '--trace', '0'], capture_output=True, text=True,
                       env=env, cwd=PB.parent, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'CUDA card' in p.stderr


def test_only_paths_is_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and ``portbench/``, the
    run fails without a result."""
    import shutil
    shutil.copy(PB.parent / 'BENCHMARK.json', tmp_path)
    shutil.copytree(PB, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'r3det_r50.serve_dense', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_no_module_loaded_is_jax_or_the_jax_package(tmp_path):
    """A whole tiny run, the readers included, in a fresh process: no
    loaded module's top-level name is jax, jaxlib, flax or r3det_tpu."""
    code = f"""
import sys
sys.path.insert(0, {str(PB / 'tests')!r})
sys.path.insert(0, {str(PB.parent)!r})
import portbench.bench.cli, portbench.bench.serve, portbench.bench.train
import portbench.readings
from conftest import make_tiny, run_cell
man = make_tiny({str(tmp_path)!r})
run_cell(man, 'tiny_rr.sparse')
for m in man.data['per_layer'] + list(__import__('portbench.bench.manifest',
        fromlist=['x']).Manifest().data['per_layer']):
    man.reader(m)
from portbench.bench.common import forbidden_modules
print(forbidden_modules())
"""
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'r3det_tpu_torch_x', sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'r3det_tpu.models', sys)
    assert common.forbidden_modules() == ['r3det_tpu']


# --- correct under the control and planted faults -------------------------

@pytest.mark.parametrize('control', ['int8_path', 'reference_below'])
def test_serve_control_fails(control):
    """The controls fail the shipped limits: the program's own int8 path in
    the program's place, and, on the sound bf16 program's outputs, the
    reference one precision below where that path leaves the program in
    bf16 or float32 (final convs in fp8, decode and NMS in bfloat16)."""
    from conftest import tiny_config

    from portbench.bench import check
    cfg = tiny_config('r3det_r50')
    man = Manifest()
    limits = man.limits('r3det_r50.serve_dense')['numbers']
    traffic = json.loads((PB / 'traffic' / 'serve_dense.json').read_text())
    traffic.update(batch=2, size=128, pool=1, calibration_images=2,
                   shape=[{'layer': 'bbox_head.retina_cls'},
                          {'layer': 'refine_head_0.retina_cls',
                           'live': 150}])
    if control == 'int8_path':
        traffic['model_options'] = {'quantize': 'static',
                                    'quantize_head': 'static',
                                    'int8_act': True}
    b = serve.build(dict(cfg, compute_dtype='bfloat16'), traffic, 21,
                    torch.device('cpu'))
    last = {}
    serve.capture(b['model'], last)
    dets = b['step'](b['pool'][0])
    nums, _ = check.serve_numbers([(b['pool'][0], dict(last), dets)],
                                  b['ref'], b['rcfg'], b['sizes'],
                                  (128, 128),
                                  control=control == 'reference_below')
    assert any(nums[k] > lim['limit'] for k, lim in limits.items())


def test_serve_k2_fault_fails(tiny, monkeypatch):
    """K2's sample at transposed coordinates, planted in the program's
    FRM: ``err.frm0`` fails its limit."""
    import r3det_tpu_torch.models.frm as frm
    real = frm.frm_sample_levels_reference
    monkeypatch.setattr(frm, 'frm_sample_levels_reference',
                        lambda xs, fs, rois, scales, points, quirk: real(
                            xs, fs, rois, scales, points, not quirk))
    out = run_cell(tiny, 'tiny_r3det.serve')
    assert out['correct'] is False
    assert out['checks']['err.frm0']['value'] > \
        out['checks']['err.frm0']['limit']


def corrupt(fn, how):
    def wrapped(*a, **k):
        dets, labels, num = fn(*a, **k)[:3]
        dets, num = dets.clone(), num.clone()
        if how == 'answer':
            dets[0, 0, 5] += 0.01
        else:                                 # half the batch left out
            num[num.shape[0] // 2:] = 0
        return dets, labels, num
    return wrapped


@pytest.mark.parametrize('how', ['answer', 'half_batch'])
def test_serve_faults_fail(tiny, monkeypatch, how):
    import r3det_tpu_torch.parallel.predict as pp
    monkeypatch.setattr(pp, 'detector_predict',
                        corrupt(pp.detector_predict, how))
    out = run_cell(tiny, 'tiny_rr.sparse')
    assert out['correct'] is False
    assert out['checks']['det_mismatch']['value'] > \
        out['checks']['det_mismatch']['limit']


@pytest.mark.parametrize('how', ['unchanged', 'half_batch'])
def test_train_faults_fail(tiny, monkeypatch, how):
    import r3det_tpu_torch.parallel.train as pt
    if how == 'unchanged':
        monkeypatch.setattr(pt.SGD, 'step', lambda self, grads: None)
    else:
        real = pt.loss_and_grads

        def half(model, cfg, sizes, batch, *a, **k):
            return real(model, cfg, sizes, {n: v[:1] for n, v in
                                            batch.items()}, *a, **k)
        monkeypatch.setattr(pt, 'loss_and_grads', half)
    out = run_cell(tiny, 'tiny_r3det.train')
    assert out['correct'] is False


def test_train_sound_run_is_correct(tiny):
    out = run_cell(tiny, 'tiny_r3det.train')
    assert out['correct'], out['checks']
    assert set(out['checks']) == set(
        tiny.limits('tiny_r3det.train')['numbers'])
