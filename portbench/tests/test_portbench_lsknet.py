"""The ``lsknet`` backbone's benchmark files: the conv count against
PyTorch's counter on the reference and at LSKNet-S's 1024^2, the seed
rule, the sub-blocks' least work against a hand count, the reference
importing nothing of the program, the span readers on a synthetic trace,
three faults planted in the program against the cell's ``err.fpn``
limit, a tiny LSKNet cell through the harness, and the fp8 control of
``err.fpn``."""
import ast
import json
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import PB, make_tiny, run_cell

from portbench.bench import check, common, trace
from portbench.bench.manifest import Manifest, backbone_file
from portbench.reference.model import Conv, Detector
from portbench.work import flops, lsknet

CELL = 'rretinanet_obb_lsknet_s.serve_sparse'
SMALL = dict(lsk_embed_dims=[16, 32, 40, 64], lsk_depths=[1, 1, 2, 1],
             lsk_mlp_ratios=[8, 8, 4, 4], feat_channels=32,
             compute_dtype='float32')


def shipped():
    return json.loads((PB / 'configs' / 'rretinanet_obb_lsknet_s.json')
                      .read_text())


def small():
    cfg = dict(shipped(), **SMALL)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


def limit(name):
    return json.loads((PB / 'limits' / f'{CELL}.json').read_text())[
        'numbers'][name]['limit']


@pytest.mark.parametrize('hw', [(96, 80), (70, 70)])
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
    assert chans == ref.backbone.out_channels == (16, 32, 40, 64)


def test_shipped_config_at_1024():
    """LSKNet-S at 1024^2: 53.82 GMAC, within 2% of the published 54.4
    (the paper counts 54.4 at 1024^2), 4.84 of them the patch
    embeddings; 359.75 GFLOP an image's forward with the FPN and head."""
    cfg = shipped()
    ops, chans = backbone_file(cfg, 'work').ops(cfg, 1024, 1024)
    total = sum(m for _, m, _, _ in ops)
    assert total == 53815091200
    assert abs(total / 54.4e9 - 1) < 0.02
    assert sum(m for n, m, _, _ in ops
               if n.startswith('patch_embed')) == 4844421120
    assert chans == (64, 128, 320, 512)
    assert flops.forward_flops(cfg, 1024) == 359748878336
    pcfg = common.program_config(cfg)
    hash(pcfg)
    assert pcfg.backbone == 'lsknet' and pcfg.lsk_depths == (2, 2, 4, 2)


def test_every_reference_conv_takes_the_control():
    ref = Detector(small())
    convs = [m for m in ref.backbone.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 4 + 5 * 11
    assert all(isinstance(m, Conv) for m in convs)


def test_seed_rule_leaves_no_identity_bn_or_zero_layer_scale():
    torch.set_num_threads(2)
    ref = Detector(shipped())
    state = common.seeded_state(ref, 11, torch.device('cpu'))
    seen = {}
    for name, t in state.items():
        if not name.startswith('backbone.'):
            continue
        parts = name.split('.')
        leaf = parts[-1]
        if leaf.startswith('layer_scale_'):
            assert torch.equal(t, torch.ones_like(t))
            kind = 'layer_scale'
        elif leaf == 'num_batches_tracked':
            kind = 'count'
        elif len(parts) == 3 and parts[1].startswith('norm'):
            assert bool((t == (1.0 if leaf == 'weight' else 0.0)).all())
            kind = 'layernorm'
        elif parts[-2] in ('norm', 'norm1', 'norm2'):
            if leaf == 'running_var':
                assert bool((t == 2.0).all())
            else:
                std = {'weight': 1.0, 'bias': 0.5, 'running_mean': 1.0}
                assert float(t.std()) == pytest.approx(std[leaf], rel=0.3)
            kind = 'bn.' + leaf
        elif leaf == 'weight':
            assert float(t.std()) == pytest.approx(t[0].numel() ** -0.5,
                                                   rel=0.1)
            kind = 'conv'
        else:
            assert leaf == 'bias' and not t.any()
            kind = 'bias'
        seen[kind] = seen.get(kind, 0) + 1
    # 4 embedding BNs and 2 a block in 10 blocks
    assert {k: v for k, v in seen.items() if k.startswith('bn.')} == {
        'bn.' + leaf: 24 for leaf in ('weight', 'bias', 'running_mean',
                                      'running_var')}
    assert seen['layer_scale'] == 20 and seen['layernorm'] == 8


def test_sub_block_work_matches_a_hand_count():
    """Batch 2 of 96 x 80, the small LSKNet: stage 1 is 24 x 20 positions
    of 16 channels, 128 hidden; the last stage 3 x 3 of 64."""
    att = lsknet.blocks(small(), 'attn', 2, 96, 80)
    mlp = lsknet.blocks(small(), 'mlp', 2, 96, 80)
    assert len(att) == len(mlp) == 5
    n, c, h = 2 * 24 * 20, 16, 128
    weights = (2 * c + c * c + c + 76 * c + 2 * (c * 8 + 8) + 198
               + 8 * c + c + c * c + c + c)
    tensor = 2 * (c * c + c * 8 * 2 + 8 * c + c * c)
    f32 = (2 + 4 + 8 + 150 + 2 + 1.5 + 2 + 2) * c + 394 + 8
    assert att[0] == (n * 4 * c + 2 * weights, n * tensor, n * f32)
    weights = 2 * c + c * h + h + 10 * h + h * c + c + c
    f32 = 5 * c + (1 + 19 + 8) * h
    assert mlp[0] == (n * 4 * c + 2 * weights, n * 4 * c * h, n * f32)
    assert lsknet.least_s(small(), 'mlp', 2, 96, 80) == pytest.approx(
        sum(max(b / 3.35e12, t / 989e12, f / 67e12) for b, t, f in mlp))


def test_shipped_bounds_at_1024():
    """Batch 8 of 1024^2: the taps bound the attention but in stage 4 and
    the MLP in stage 1; 0.404 and 0.655 ms a step."""
    cfg = shipped()
    assert lsknet.bound_by(cfg, 'attn', 8, 1024, 1024) == [
        'f32', 'f32', 'f32', 'tensor']
    assert lsknet.bound_by(cfg, 'mlp', 8, 1024, 1024) == [
        'f32', 'tensor', 'tensor', 'tensor']
    assert lsknet.least_s(cfg, 'attn', 8, 1024, 1024) == pytest.approx(
        0.404e-3, rel=1e-3)
    assert lsknet.least_s(cfg, 'mlp', 8, 1024, 1024) == pytest.approx(
        0.655e-3, rel=1e-3)


NEW_FILES = ('reference/backbones/lsknet.py', 'work/backbones/lsknet.py',
             'work/lsknet.py', 'metrics/lsk_attn_ms.serve.py',
             'metrics/lsk_mlp_ms.serve.py',
             'metrics/lsk_attn_roofline.serve.py',
             'metrics/lsk_mlp_roofline.serve.py')


@pytest.mark.parametrize('path', NEW_FILES)
def test_new_files_import_nothing_of_the_program(path):
    tree = ast.parse((PB / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)      # relative: portbench
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert all(n.split('.')[0] in ('torch', 'math', 'portbench')
               for n in names), names


def test_reference_lsknet_runs_without_the_program():
    code = (
        'import sys, json, torch\n'
        f'sys.path.insert(0, {str(PB.parent)!r})\n'
        'from portbench.reference.model import Detector\n'
        f'cfg = json.loads(open({str(PB / "configs" / "rretinanet_obb_lsknet_s.json")!r}).read())\n'  # noqa: E501
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
              ('r3det.backbone.lsk.attn', 100, 200),
              ('r3det.backbone.lsk.attn', 400, 500),
              ('r3det.backbone.lsk.mlp', 200, 300),
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
    traffic = {'batch': 2, 'size': 96}
    run = {'program_trace': synthetic(steps), 'cfg': small(),
           'traffic': traffic}

    def read(name):
        return man.reader({'name': name})(run)
    assert read('lsk_attn_ms.serve') == pytest.approx(0.11)
    assert read('lsk_mlp_ms.serve') == pytest.approx(0.06)
    for part, ms in (('attn', 0.11), ('mlp', 0.06)):
        least = lsknet.least_s(small(), part, 2, 96, 96)
        assert read(f'lsk_{part}_roofline.serve') == pytest.approx(
            100 * least / (ms * 1e-3))
    for empty in ({'program_trace': None}, {}):
        run = dict(empty, cfg=small(), traffic=traffic)
        for name in ('lsk_attn_ms.serve', 'lsk_mlp_ms.serve',
                     'lsk_attn_roofline.serve', 'lsk_mlp_roofline.serve'):
            assert read(name) is None
    tr = synthetic(steps)
    tr.device = [d for d in tr.device if 'lsk' not in d[2]]
    run = {'program_trace': tr, 'cfg': small(), 'traffic': traffic}
    assert read('lsk_mlp_ms.serve') is None
    assert read('lsk_attn_roofline.serve') is None


def _shortcut_from_input(self, x):
    """``Block.forward`` with the attention's shortcut taken from the block
    input instead of ``norm1``'s output."""
    ls1 = self.layer_scale_1.view(1, -1, 1, 1)
    ls2 = self.layer_scale_2.view(1, -1, 1, 1)
    a = self.attn
    y = a.proj_2(a.spatial_gating_unit(torch.nn.functional.gelu(
        a.proj_1(self.norm1(x))))) + x
    x = x + ls1 * y
    return x + ls2 * self.mlp(self.norm2(x))


def _bn_left_out(model):
    model.backbone.block3[1].norm2 = torch.nn.Identity()


def _weights_swapped(model, monkeypatch):
    from r3det_tpu_torch.models import lsknet as program
    select = program.LSKblock.select
    monkeypatch.setattr(program.LSKblock, 'select',
                        lambda self, b1, b2: select(self, b1, b2).flip(1))


def _shortcut(model, monkeypatch):
    from r3det_tpu_torch.models import lsknet as program
    monkeypatch.setattr(program.Block, 'forward', _shortcut_from_input)


FAULTS = {'bn_left_out': lambda m, mp: _bn_left_out(m),
          'selection_swapped': _weights_swapped,
          'shortcut_from_block_input': _shortcut}


@pytest.fixture(scope='module')
def small_pair():
    torch.set_num_threads(2)
    cfg = small()
    ref = Detector(cfg)
    state = common.seeded_state(ref, 21, torch.device('cpu'))
    ref.load_state_dict(state)
    return cfg, ref, state


def fpn_err(cfg, ref, state, plant=None):
    from r3det_tpu_torch.models.detectors import build_detector
    model = build_detector(common.program_config(cfg), dtype=torch.float32,
                           device='cpu')
    model.load_state_dict(state)
    if plant:
        plant(model)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(2, 128, 128, 3, generator=g) * 4 - 2
    with torch.no_grad():
        return check.rel_err(model.neck(model.backbone(x)),
                             ref.neck(ref.backbone(x)))


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_planted_fault_moves_err_fpn_past_its_limit(small_pair, fault,
                                                     monkeypatch):
    cfg, ref, state = small_pair
    assert fpn_err(cfg, ref, state) < 1e-5
    err = fpn_err(cfg, ref, state,
                  lambda m: FAULTS[fault](m, monkeypatch))
    assert err > 2 * limit('err.fpn'), err


@pytest.fixture
def tiny_lsk(tmp_path):
    """The tiny manifest with an LSKNet cell, ``tiny_lsk.sparse``."""
    torch.set_num_threads(2)
    man = make_tiny(tmp_path)
    (tmp_path / 'configs' / 'tiny_lsk.json').write_text(json.dumps(small()))
    (tmp_path / 'limits' / 'tiny_lsk.sparse.json').write_text(
        (PB / 'limits' / f'{CELL}.json').read_text())
    bench = json.loads(man.path.read_text())
    bench['configs'].append({'name': 'tiny_lsk',
                             'file': 'configs/tiny_lsk.json'})
    bench['workloads'].append({'name': 'tiny_lsk.sparse',
                               'config': 'tiny_lsk', 'traffic': 'sparse',
                               'chips': 1})
    bench['end_to_end'][0]['workloads'].append('tiny_lsk.sparse')
    man.path.write_text(json.dumps(bench))
    return Manifest(man.path, base=tmp_path)


def test_tiny_lsknet_cell_reads_correct(tiny_lsk):
    out = run_cell(tiny_lsk, 'tiny_lsk.sparse')
    assert out['correct'] and out['failed'] == 0
    assert out['metrics']['patches_per_s']['value'] > 0
    assert set(out['checks']) == set(json.loads(
        (PB / 'limits' / f'{CELL}.json').read_text())['numbers'])


def test_fp8_control_reads_far_above_the_program(tiny_lsk):
    from portbench import fp8_control
    got = {kind: nums for kind, nums, _ in fp8_control.readings(
        tiny_lsk.config('tiny_lsk'), tiny_lsk.traffic('sparse'),
        98765432109, torch.device('cpu'))}
    sound, low = got['program'], got['control_fp8']
    assert set(sound) == set(low)
    for key in ('err.fpn', 'err.tower.s0.cls', 'err.tower.s0.reg',
                'err.final.s0.cls', 'err.final.s0.reg'):
        assert sound[key] < 1e-5 and low[key] > 0.01, key
