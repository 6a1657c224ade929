"""The ``vitdet`` backbone's benchmark files: the product count against
PyTorch's counter on the reference and at ViT-B's 1024^2 (487.6 GMAC),
the seed rule, the sub-blocks' least work against a hand count, the
reference importing nothing of the program, the span readers on a
synthetic trace, three faults planted in the program against the cell's
``err.fpn`` limit, a tiny ViT cell through the harness, and the fp8
control of ``err.fpn``."""
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
from portbench.work import flops, vitdet

CELL = 'rretinanet_obb_vitdet_b.serve_sparse'
# embed 96, 3 heads of 32, depth 4 with global blocks 1 and 3, window 4:
# a 160^2 image is a 10 x 10 grid, which window 4 pads to 12 (unmasked)
SMALL = dict(vit_embed_dim=96, vit_num_heads=3, vit_depth=4,
             vit_global_blocks=[1, 3], vit_window_size=4, vit_img_size=160,
             feat_channels=32, compute_dtype='float32')


def shipped():
    return json.loads((PB / 'configs' / 'rretinanet_obb_vitdet_b.json')
                      .read_text())


def small():
    cfg = dict(shipped(), **SMALL)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


def limit(name):
    return json.loads((PB / 'limits' / f'{CELL}.json').read_text())[
        'numbers'][name]['limit']


@pytest.mark.parametrize('size', [160, 128])
def test_forward_flops_match_the_counter(size):
    """At 160^2 the window blocks pad 10 to 12; at 128^2 the global
    blocks' tables (built for 10 x 10) are resized to 8 x 8's."""
    torch.set_num_threads(2)
    cfg = small()
    ref = Detector(cfg)
    x = torch.rand(2, size, size, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(x)
    assert fc.get_total_flops() == 2 * flops.forward_flops(cfg, size)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.backbone(x)
    ops, chans = backbone_file(cfg, 'work').ops(cfg, size, size)
    assert fc.get_total_flops() == 2 * 2 * sum(m for _, m, _, _ in ops)
    assert chans == ref.backbone.out_channels == (48, 96, 96)


def test_shipped_config_at_1024():
    """ViT-B at 1024^2: 487.65 GMAC, of them the patch embedding 2.42,
    the 12 blocks' qkv, proj and MLP 29.0 each and 1.90 more on each
    window block's padded tokens, global q.k^T and P.v 25.77 a block,
    window 1.48, the relative einsums 0.403 a global and 0.105 a window
    block, the transposed conv 4.83; 1230.9 GFLOP an image's forward with
    the FPN and head."""
    cfg = shipped()
    ops, chans = backbone_file(cfg, 'work').ops(cfg, 1024, 1024)
    total = sum(m for _, m, _, _ in ops)
    assert total == 487649280000
    assert abs(total / 487.6e9 - 1) < 0.01

    def part(suffix, blocks):
        return sum(m for n, m, _, _ in ops if n.endswith(suffix)
                   and int(n.split('.')[1]) in blocks)
    glob, win = (2, 5, 8, 11), (0, 1, 3, 4, 6, 7, 9, 10)
    assert part('.attn.qk', glob) == part('.attn.av', glob) \
        == 4 * 12884901888
    assert part('.attn.qk', win) == 8 * 737587200
    assert part('.attn.rel_pos', glob) == 4 * 402653184
    assert part('.attn.rel_pos', win) == 8 * 105369600
    dense = sum(m for n, m, _, _ in ops if n.endswith(
        ('.qkv', '.proj', '.fc1', '.fc2')) and n.startswith('blocks.'))
    assert dense == 12 * 28991029248 + 8 * (4900 - 4096) * 4 * 768 ** 2
    assert dict((n, m) for n, m, _, _ in ops)['simfp_3.0'] == 4831838208
    assert chans == (384, 768, 768)
    assert flops.forward_flops(cfg, 1024) == 1230940471296
    pcfg = common.program_config(cfg)
    hash(pcfg)
    assert pcfg.backbone == 'vitdet'
    assert pcfg.vit_global_blocks == (2, 5, 8, 11)


def test_every_reference_product_takes_the_control():
    ref = Detector(small())
    mods = list(ref.backbone.modules())
    linears = [m for m in mods if isinstance(m, torch.nn.Linear)]
    assert len(linears) == 4 * 4
    assert all(hasattr(m, 'quant') for m in linears)
    convs = [m for m in mods if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 1 and isinstance(convs[0], Conv)
    deconvs = [m for m in mods if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(deconvs) == 1 and hasattr(deconvs[0], 'quant')
    x = torch.rand(1, 160, 160, 3)
    with torch.no_grad():
        want = ref.backbone(x)
        low = check.quantized(ref.backbone, 'fp8', x)
    assert all(check.rel_err([a], [b]) > 0.01 for a, b in zip(low, want))


def test_seed_rule_draws_every_table_and_bias():
    torch.set_num_threads(2)
    ref = Detector(shipped())
    state = common.seeded_state(ref, 11, torch.device('cpu'))
    seen = {}
    for name, t in state.items():
        if not name.startswith('backbone.'):
            continue
        module, _, leaf = name.rpartition('.')
        if leaf == 'pos_embed':
            assert float(t.std()) == pytest.approx(0.02, rel=0.05)
            kind = 'pos_embed'
        elif leaf in ('rel_pos_h', 'rel_pos_w'):
            assert float(t.std()) == pytest.approx(0.1, rel=0.2)
            kind = 'rel_pos'
        elif module.endswith(('norm1', 'norm2')):
            assert bool((t == (1.0 if leaf == 'weight' else 0.0)).all())
            kind = 'layernorm'
        else:
            w = state[f'{module}.weight']
            fan = w.shape[0] if 'simfp_' in module else w[0].numel()
            assert float(t.std()) == pytest.approx(fan ** -0.5, rel=0.15)
            kind = leaf
        seen[kind] = seen.get(kind, 0) + 1
    # 4 linears a block, the patch conv and the transposed conv
    assert seen == {'pos_embed': 1, 'rel_pos': 24, 'layernorm': 48,
                    'weight': 50, 'bias': 50}


def test_sub_block_work_matches_a_hand_count():
    """Batch 2 of 160^2, the small ViT: a 10 x 10 grid, the windows of 4
    on the 12 x 12 padded grid, 3 heads of 32, hidden 384."""
    cfg = small()
    c, d, t = 96, 32, 2 * 100
    weights = 2 * c + 4 * c * c + 4 * c
    glob = vitdet.sub_block(cfg, 'global_attn', 2, 160, 160)
    macs = t * 4 * c * c + 2 * 2 * 3 * 100 ** 2 * d + 2 * 3 * 100 * 20 * d
    assert glob == (2 * (2 * t * c + 2 * t * 4 * c + weights + 38 * d),
                    2 * macs)
    win = vitdet.sub_block(cfg, 'window_attn', 2, 160, 160)
    p = 2 * 144
    macs = p * 4 * c * c + 2 * 18 * 3 * 16 ** 2 * d + 18 * 3 * 16 * 8 * d
    assert win == (2 * (2 * t * c + 2 * p * 4 * c + weights + 14 * d),
                   2 * macs)
    mlp = vitdet.sub_block(cfg, 'mlp', 2, 160, 160)
    assert mlp == (2 * (2 * t * c + 2 * t * 384 + 2 * c + 2 * c * 384 + 384
                        + c), 2 * 2 * t * c * 384)
    assert [vitdet.count(cfg, k) for k in vitdet.PARTS] == [2, 2, 4]
    assert vitdet.least_s(cfg, 'mlp', 2, 160, 160) == pytest.approx(
        4 * max(mlp[0] / 3.35e12, mlp[1] / 989e12))


def test_shipped_bounds_at_1024():
    """Batch 8 of 1024^2: the products bound every sub-block; 0.580,
    0.213 and 0.313 ms each, 7.77 ms the blocks of a step."""
    cfg = shipped()
    for part in vitdet.PARTS:
        assert vitdet.bound_by(cfg, part, 8, 1024, 1024) == 'tensor'
    one = {p: vitdet.least_s(cfg, p, 8, 1024, 1024) / vitdet.count(cfg, p)
           for p in vitdet.PARTS}
    assert one['global_attn'] == pytest.approx(0.5798e-3, rel=1e-3)
    assert one['window_attn'] == pytest.approx(0.2126e-3, rel=1e-3)
    assert one['mlp'] == pytest.approx(0.3127e-3, rel=1e-3)
    assert sum(vitdet.least_s(cfg, p, 8, 1024, 1024)
               for p in vitdet.PARTS) == pytest.approx(7.772e-3, rel=1e-3)


NEW_FILES = ('reference/backbones/vitdet.py', 'work/backbones/vitdet.py',
             'work/vitdet.py', 'metrics/vit_global_attn_ms.serve.py',
             'metrics/vit_window_attn_ms.serve.py',
             'metrics/vit_mlp_ms.serve.py',
             'metrics/vit_global_attn_roofline.serve.py',
             'metrics/vit_window_attn_roofline.serve.py')


@pytest.mark.parametrize('path', NEW_FILES)
def test_new_files_import_nothing_of_the_program(path):
    tree = ast.parse((PB / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)      # relative: portbench
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert all(n.split('.')[0] in ('torch', 'math', 'portbench')
               for n in names), names


def test_reference_vitdet_runs_without_the_program():
    code = (
        'import sys, json, torch\n'
        f'sys.path.insert(0, {str(PB.parent)!r})\n'
        'from portbench.reference.model import Detector\n'
        f'cfg = json.loads(open({str(PB / "configs" / "rretinanet_obb_vitdet_b.json")!r}).read())\n'  # noqa: E501
        f'cfg.update({SMALL!r})\n'
        'Detector(cfg)(torch.rand(1, 64, 64, 3))\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("r3det_tpu_torch", "r3det_tpu", "jax"))\n'
        'print(json.dumps(bad))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


SPANS = ('global_attn', 'window_attn', 'mlp')


def synthetic(steps=2):
    """Each step of 1000 us: a global range (GPU copy 100-200), two window
    ranges (300-350, 600-650), one MLP range (200-300), device ops
    overlapping their edges, and an op outside every range."""
    device = [('k', 90, 150), ('k', 140, 180), ('k', 190, 260),
              ('k', 320, 330), ('k', 640, 700), ('k', 800, 900),
              ('r3det.backbone.vit.global_attn', 100, 200),
              ('r3det.backbone.vit.window_attn', 300, 350),
              ('r3det.backbone.vit.window_attn', 600, 650),
              ('r3det.backbone.vit.mlp', 200, 300),
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
    """global: [100, 180] + [190, 200] = 90 us a step; window: [320, 330]
    + [640, 650] = 20 us; mlp: [200, 260] = 60 us."""
    man = Manifest()
    traffic = {'batch': 2, 'size': 160}
    run = {'program_trace': synthetic(steps), 'cfg': small(),
           'traffic': traffic}

    def read(name):
        return man.reader({'name': name})(run)
    want = {'global_attn': 0.09, 'window_attn': 0.02, 'mlp': 0.06}
    for part, ms in want.items():
        assert read(f'vit_{part}_ms.serve') == pytest.approx(ms)
    for part in ('global_attn', 'window_attn'):
        least = vitdet.least_s(small(), part, 2, 160, 160)
        assert read(f'vit_{part}_roofline.serve') == pytest.approx(
            100 * least / (want[part] * 1e-3))
    names = [f'vit_{p}_ms.serve' for p in SPANS] + [
        f'vit_{p}_roofline.serve' for p in ('global_attn', 'window_attn')]
    for empty in ({'program_trace': None}, {}):
        run = dict(empty, cfg=small(), traffic=traffic)
        for name in names:
            assert read(name) is None
    tr = synthetic(steps)
    tr.device = [d for d in tr.device if '.vit.' not in d[2]]
    run = {'program_trace': tr, 'cfg': small(), 'traffic': traffic}
    for name in names:
        assert read(name) is None


def _no_relative_terms(model, monkeypatch):
    """q's relative columns zeroed: the logits lose both terms."""
    from r3det_tpu_torch.models import vitdet as program
    real = program.Attention.augmented

    def augmented(self, q, k, h, w):
        qa, ka = real(self, q, k, h, w)
        d = q.shape[-1]
        return torch.cat([qa[..., :d], torch.zeros_like(qa[..., d:])],
                         -1), ka
    monkeypatch.setattr(program.Attention, 'augmented', augmented)


def _pad_masked(model, monkeypatch):
    """Each window block's padded keys masked out of the softmax."""
    import torch.nn.functional as F

    from r3det_tpu_torch.models import vitdet as program
    from r3det_tpu_torch.models.swin import window_partition

    def windowed(self, y):
        b, h, w, c = y.shape
        win, att = self.window, self.attn
        hp, wp = program.padded(h, win), program.padded(w, win)
        keep = torch.zeros(1, hp, wp, 1)
        keep[:, :h, :w] = 1
        valid = window_partition(keep, win).view(-1, win * win) > 0
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        u = window_partition(y, win)
        n, heads = u.shape[0], att.num_heads
        q, k, v = att.qkv(u).view(n, win * win, 3, heads, c // heads) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        qa, ka = att.augmented(q, k, win, win)
        o = F.scaled_dot_product_attention(
            qa, ka, v, attn_mask=valid.repeat(b, 1)[:, None, None, :],
            scale=1.0)
        o = att.proj(o.transpose(1, 2).reshape(n, win * win, c))
        return program.window_reverse(o, win, hp, wp)[:, :h, :w]
    monkeypatch.setattr(program.Block, 'windowed', windowed)


def _global_windowed(model, monkeypatch):
    model.backbone.blocks[1].window = 4


FAULTS = {'relative_terms_left_out': _no_relative_terms,
          'pad_masked': _pad_masked,
          'global_block_windowed': _global_windowed}


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
    x = torch.rand(2, 160, 160, 3, generator=g) * 4 - 2
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
def tiny_vit(tmp_path):
    """The tiny manifest with a ViT cell, ``tiny_vit.sparse``: the small
    ViT on the tiny traffic's 128^2 images (an 8 x 8 grid, windows of 4,
    the global tables resized from 10 x 10's)."""
    torch.set_num_threads(2)
    man = make_tiny(tmp_path)
    (tmp_path / 'configs' / 'tiny_vit.json').write_text(json.dumps(small()))
    (tmp_path / 'limits' / 'tiny_vit.sparse.json').write_text(
        (PB / 'limits' / f'{CELL}.json').read_text())
    bench = json.loads(man.path.read_text())
    bench['configs'].append({'name': 'tiny_vit',
                             'file': 'configs/tiny_vit.json'})
    bench['workloads'].append({'name': 'tiny_vit.sparse',
                               'config': 'tiny_vit', 'traffic': 'sparse',
                               'chips': 1})
    bench['end_to_end'][0]['workloads'].append('tiny_vit.sparse')
    man.path.write_text(json.dumps(bench))
    return Manifest(man.path, base=tmp_path)


def test_tiny_vit_cell_reads_correct(tiny_vit):
    out = run_cell(tiny_vit, 'tiny_vit.sparse')
    assert out['correct'] and out['failed'] == 0
    assert out['metrics']['patches_per_s']['value'] > 0
    assert set(out['checks']) == set(json.loads(
        (PB / 'limits' / f'{CELL}.json').read_text())['numbers'])


def test_fp8_control_reads_far_above_the_program(tiny_vit):
    from portbench import fp8_control
    got = {kind: nums for kind, nums, _ in fp8_control.readings(
        tiny_vit.config('tiny_vit'), tiny_vit.traffic('sparse'),
        98765432109, torch.device('cpu'))}
    sound, low = got['program'], got['control_fp8']
    assert set(sound) == set(low)
    for key in ('err.fpn', 'err.tower.s0.cls', 'err.tower.s0.reg',
                'err.final.s0.cls', 'err.final.s0.reg'):
        assert sound[key] < 1e-5 and low[key] > 0.01, key
