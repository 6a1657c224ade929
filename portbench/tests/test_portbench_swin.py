"""The ``swin`` backbone's benchmark files: the FLOP count against PyTorch's
counter on the reference, the seed rule, the attention sub-blocks' least
work against a hand count, the reference importing nothing of the
program, the span readers on a synthetic trace, a tiny Swin cell through
the harness, and the fp8 control of ``err.fpn``."""
import ast
import json
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import PB, make_tiny, run_cell

from portbench.bench import common, trace
from portbench.bench.manifest import Manifest, backbone_file
from portbench.reference.model import Detector
from portbench.work import flops, swin

CELL = 'rretinanet_obb_swin_t.serve_sparse'
SMALL = dict(swin_embed_dims=32, swin_depths=[2, 2, 2, 2],
             swin_num_heads=[1, 2, 4, 8], feat_channels=32,
             compute_dtype='float32')


def shipped():
    return json.loads((PB / 'configs' / 'rretinanet_obb_swin_t.json')
                      .read_text())


def small():
    cfg = dict(shipped(), **SMALL)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


@pytest.mark.parametrize('hw', [(100, 100), (64, 96)])
def test_forward_flops_match_the_counter(hw):
    torch.set_num_threads(2)
    cfg = small()
    ref = Detector(cfg)
    x = torch.rand(2, *hw, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(x)
    assert fc.get_total_flops() == 2 * flops.forward_flops(cfg, *hw)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.backbone(x)
    ops, chans = backbone_file(cfg, 'work').ops(cfg, *hw)
    assert fc.get_total_flops() == 2 * 2 * sum(m for _, m, _, _ in ops)
    assert chans == ref.backbone.out_channels == (64, 128, 256)


def test_shipped_config_at_1024():
    """Swin-T at 1024^2: 98.41 GMAC in the backbone, 36.50 of them in the
    attention sub-blocks; 450.05 GFLOP an image's forward."""
    cfg = shipped()
    ops, chans = backbone_file(cfg, 'work').ops(cfg, 1024, 1024)
    assert sum(m for _, m, _, _ in ops) == 98410120320
    assert sum(m for n, m, _, _ in ops if n.endswith(
        ('.qkv', '.qk', '.av', '.proj'))) == 36502193280
    assert chans == (192, 384, 768)
    assert flops.forward_flops(cfg, 1024) == 450046232832
    pcfg = common.program_config(cfg)
    hash(pcfg)
    assert pcfg.backbone == 'swin' and pcfg.swin_depths == (2, 2, 6, 2)


def test_seed_rule_leaves_no_linear_gain_or_table_at_zero():
    torch.set_num_threads(2)
    ref = Detector(shipped())
    state = common.seeded_state(ref, 11, torch.device('cpu'))
    built = ref.state_dict()
    seen = set()
    for name, t in state.items():
        if not name.startswith('backbone.'):
            continue
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'relative_position_index':
            assert torch.equal(t, built[name])
            kind = 'index'
        elif leaf == 'relative_position_bias_table':
            assert float(t.std()) == pytest.approx(1.0, rel=0.1)
            kind = 'table'
        elif leaf == 'weight' and t.dim() == 1:
            assert torch.equal(t, torch.ones_like(t))
            kind = 'gain'
        elif leaf == 'weight':
            assert float(t.std()) == pytest.approx(t[0].numel() ** -0.5,
                                                   rel=0.05)
            kind = 'linear' if t.dim() == 2 else 'conv'
        else:
            assert leaf == 'bias' and not t.any()
            kind = 'bias'
        seen.add(kind)
    assert seen == {'index', 'table', 'gain', 'linear', 'conv', 'bias'}


def test_attn_work_matches_a_hand_count():
    """Batch 2 of 100 x 100, the small Swin: stage 1 is 25 x 25 tokens of
    32 channels padded to 28 x 28, 16 windows of 49 tokens, one head."""
    blocks = swin.attn_blocks(small(), 2, 100, 100)
    assert len(blocks) == 8
    nbytes, tc, f32 = blocks[0]
    scores = 2 * 16 * 1 * 49 * 49
    macs = 2 * 28 * 28 * (3 * 32 * 32 + 32 * 32) + 2 * scores * 32
    weights = 2 * 32 + 3 * 32 * 32 + 3 * 32 + 32 * 32 + 32 + 13 * 13 * 1
    assert (nbytes, tc, f32) == (2 * (2 * 2 * 25 * 25 * 32 + weights),
                                 2 * macs, 5 * scores)
    # the last stage: 4 x 4 tokens of 256 channels in one 7 x 7 window
    nbytes, tc, f32 = blocks[-1]
    assert f32 == 5 * 2 * 1 * 8 * 49 * 49
    assert nbytes == 2 * (2 * 2 * 16 * 256 + 2 * 256 + 4 * 256 * 256
                          + 4 * 256 + 13 * 13 * 8)
    least = swin.attn_least_s(small(), 2, 100, 100)
    assert least == pytest.approx(sum(max(b / 3.35e12, t / 989e12,
                                          f / 67e12) for b, t, f in blocks))


NEW_FILES = ('reference/backbones/swin.py', 'work/backbones/swin.py',
             'work/swin.py', 'bench/span_device.py',
             'metrics/swin_attn_ms.serve.py', 'metrics/swin_mlp_ms.serve.py',
             'metrics/swin_attn_roofline.serve.py', 'fp8_control.py')


@pytest.mark.parametrize('path', NEW_FILES)
def test_new_files_import_nothing_of_the_program(path):
    tree = ast.parse((PB / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)      # relative: portbench
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert all(n.split('.')[0] in ('torch', 'math', 'bisect', 'portbench',
                                   'argparse', 'json', 'os', 'sys', 'time')
               for n in names), names


def test_reference_swin_runs_without_the_program():
    code = (
        'import sys, json, torch\n'
        f'sys.path.insert(0, {str(PB.parent)!r})\n'
        'from portbench.reference.model import Detector\n'
        f'cfg = json.loads(open({str(PB / "configs" / "rretinanet_obb_swin_t.json")!r}).read())\n'  # noqa: E501
        f'cfg.update({SMALL!r})\n'
        'Detector(cfg)(torch.rand(1, 64, 64, 3))\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("r3det_tpu_torch", "r3det_tpu", "jax"))\n'
        'print(json.dumps(bad))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def synthetic(steps=2):
    """Each step of 1000 us: two attention ranges (GPU copies 100-200 and
    400-500) and one MLP range (200-300), device ops overlapping their
    edges, and an op outside every range."""
    device = [('k', 90, 150), ('k', 140, 180), ('k', 190, 260),
              ('k', 420, 440), ('k', 600, 700),
              ('r3det.backbone.swin.attn', 100, 200),
              ('r3det.backbone.swin.attn', 400, 500),
              ('r3det.backbone.swin.mlp', 200, 300),
              ('r3det.predict', 10, 990)]
    tr = trace.DeviceTrace.__new__(trace.DeviceTrace)
    tr.host = [(10 + 1000 * i, 990 + 1000 * i, 'r3det.predict')
               for i in range(steps)]
    tr.device = [(a + 1000 * i, b + 1000 * i, n)
                 for i in range(steps) for n, a, b in device]
    tr.step_ranges = [(1000 * i, 1000 * i + 1000) for i in range(steps)]
    tr.start, tr.end, tr.steps = 0.0, 1000.0 * steps, steps
    return tr


@pytest.mark.parametrize('steps', [1, 2])
def test_span_readers(steps):
    """attn: [100, 180] + [190, 200] + [420, 440] = 110 us a step; mlp:
    [200, 260] = 60 us."""
    man = Manifest()
    run = {'program_trace': synthetic(steps), 'cfg': small(),
           'traffic': {'batch': 2, 'size': 100}}

    def read(name):
        return man.reader({'name': name})(run)
    assert read('swin_attn_ms.serve') == pytest.approx(0.11)
    assert read('swin_mlp_ms.serve') == pytest.approx(0.06)
    least = swin.attn_least_s(small(), 2, 100, 100)
    assert read('swin_attn_roofline.serve') == pytest.approx(
        100 * least / 0.11e-3)
    for empty in ({'program_trace': None}, {}):
        run = dict(empty, cfg=small(), traffic={'batch': 2, 'size': 100})
        assert read('swin_attn_ms.serve') is None
        assert read('swin_attn_roofline.serve') is None
    tr = synthetic(steps)
    tr.device = [d for d in tr.device if 'swin' not in d[2]]
    run = {'program_trace': tr, 'cfg': small(),
           'traffic': {'batch': 2, 'size': 100}}
    assert read('swin_mlp_ms.serve') is None


@pytest.fixture
def tiny_swin(tmp_path):
    """The tiny manifest with a Swin cell, ``tiny_swin.sparse``."""
    torch.set_num_threads(2)
    man = make_tiny(tmp_path)
    (tmp_path / 'configs' / 'tiny_swin.json').write_text(json.dumps(small()))
    (tmp_path / 'limits' / 'tiny_swin.sparse.json').write_text(
        (PB / 'limits' / f'{CELL}.json').read_text())
    bench = json.loads(man.path.read_text())
    bench['configs'].append({'name': 'tiny_swin',
                             'file': 'configs/tiny_swin.json'})
    bench['workloads'].append({'name': 'tiny_swin.sparse',
                               'config': 'tiny_swin', 'traffic': 'sparse',
                               'chips': 1})
    bench['end_to_end'][0]['workloads'].append('tiny_swin.sparse')
    man.path.write_text(json.dumps(bench))
    return Manifest(man.path, base=tmp_path)


def test_tiny_swin_cell_reads_correct(tiny_swin):
    out = run_cell(tiny_swin, 'tiny_swin.sparse')
    assert out['correct'] and out['failed'] == 0
    assert out['metrics']['patches_per_s']['value'] > 0
    assert set(out['checks']) == set(json.loads(
        (PB / 'limits' / f'{CELL}.json').read_text())['numbers'])


def test_fp8_control_reads_far_above_the_program(tiny_swin):
    from portbench import fp8_control
    got = {kind: nums for kind, nums, _ in fp8_control.readings(
        tiny_swin.config('tiny_swin'), tiny_swin.traffic('sparse'),
        98765432109, torch.device('cpu'))}
    assert set(got) == {'program', 'control_fp8'}
    sound, low = got['program'], got['control_fp8']
    assert set(sound) == set(low)
    for key in ('err.fpn', 'err.tower.s0.cls', 'err.tower.s0.reg',
                'err.final.s0.cls', 'err.final.s0.reg'):
        assert sound[key] < 1e-5 and low[key] > 0.01, key
