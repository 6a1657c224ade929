"""The benchmark's frozen float32 reference against the program's plain
routes, on the CPU at tiny sizes. These tests import the program; the
reference itself imports nothing of it."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import PB, tiny_config

from portbench.bench import common
from portbench.reference import boxes as rbx
from portbench.reference import predict as rpred
from portbench.reference import train as rtrain
from portbench.reference.model import Detector


def pair(name, seed=5):
    """The program's detector (plain routes, f32, CPU) and the reference,
    on the same seeded weights."""
    from r3det_tpu_torch.models.detectors import build_detector
    cfg = tiny_config(name)
    ref = Detector(cfg)
    state = common.seeded_state(ref, seed, torch.device('cpu'))
    ref.load_state_dict(state)
    prog = build_detector(common.program_config(cfg), dtype=torch.float32,
                          device='cpu', kernels=False,
                          **cfg['build_options'])
    prog.load_state_dict(state)
    return cfg, prog, ref


def images(seed=0, b=2, s=128):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, s, s, 3, generator=g) * 4 - 2


@pytest.mark.parametrize('name', ['r3det_r50', 'rretinanet_obb_r50'])
def test_forward_matches_program(name):
    cfg, prog, ref = pair(name)
    x = images()
    with torch.no_grad():
        p, r = prog(x), ref(x)
    flat = [('s0', p['s0'], r['s0'])] + [
        (f'sr{i}', a, b) for i, (a, b) in enumerate(zip(p.get('sr', []),
                                                        r['sr']))]
    for tag, (pc, pr), (rc, rr) in flat:
        for a, b in zip(pc + pr, rc + rr):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                       msg=tag)
    for a, b in zip(p.get('rois', [[]])[0], r['rois'][0] if r['rois']
                    else []):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


def test_refine_follows_given_rois():
    cfg, prog, ref = pair('r3det_r50')
    x = images(1)
    with torch.no_grad():
        p = prog(x)
        r = ref(x, rois=[[t + 3.0 for t in p['rois'][0]]])
        r0 = ref(x)
    assert torch.equal(r['rois'][0][0], p['rois'][0][0] + 3.0)
    assert not torch.equal(r['sr'][0][0][0], r0['sr'][0][0][0])


@pytest.mark.parametrize('name', ['r3det_r50', 'rretinanet_obb_r50'])
def test_predict_matches_program(name):
    from r3det_tpu_torch.models.detectors import detector_predict
    cfg, prog, ref = pair(name, seed=9)
    sizes = common.featmap_sizes(cfg, 128)
    x = images(2)
    shapes = [{'layer': 'bbox_head.retina_cls'}]
    if cfg['num_refine_stages']:
        shapes.append({'layer': 'refine_head_0.retina_cls', 'live': 120})
    else:
        shapes[0]['live'] = 120
    state = ref.state_dict()
    common.shape_cls(state, ref, cfg, x, shapes)
    prog.load_state_dict(state)
    with torch.no_grad():
        out = prog(x)
        dets, labels, num = detector_predict(
            out, common.program_config(cfg), sizes, img_shape=(128, 128),
            kernels=False)
    kept, sel = rpred.predict(out, cfg, sizes, (128, 128))
    assert min(int(v) for v in sel[3]) > 30
    for i, (b, s, lab) in enumerate(kept):
        n = int(num[i])
        assert n == len(s) > 0
        assert torch.equal(dets[i, :n, :5], torch.from_numpy(b))
        assert torch.equal(dets[i, :n, 5], torch.from_numpy(s))
        assert torch.equal(labels[i, :n].long(), torch.from_numpy(lab))


def test_rotated_iou_bit_equal_to_program():
    from r3det_tpu_torch.ops.rotated_iou import rotated_iou_pairwise
    g = torch.Generator().manual_seed(3)
    b = torch.cat([torch.rand(300, 2, generator=g) * 200,
                   torch.rand(300, 2, generator=g) * 40 + 2,
                   torch.rand(300, 1, generator=g) * 3 - 1.5], 1)
    assert torch.equal(rbx.rotated_iou(b, b), rotated_iou_pairwise(b, b))


def test_greedy_nms_is_sequential():
    iou = torch.tensor([[1.0, 0.5, 0.0], [0.5, 1.0, 0.5], [0.0, 0.5, 1.0]])
    labels = torch.tensor([0, 0, 0]).numpy()
    assert list(rpred.greedy(iou.numpy(), labels, 0.1)) == [0, 2]
    assert list(rpred.greedy(iou.numpy(), labels * 0 + [0, 1, 0],
                             0.1)) == [0, 1, 2]


def train_batch(seed=4):
    from portbench.bench.train import pool_batches
    traffic = dict(batch=2, size=128, pool=1, max_gt=8,
                   objects=[3, 8])
    return pool_batches(traffic, 15, seed, torch.device('cpu'))[0]


@pytest.mark.parametrize('name', ['r3det_r50', 'rretinanet_obb_r50'])
def test_losses_match_program(name):
    from r3det_tpu_torch.models.detectors import detector_loss
    cfg, prog, ref = pair(name, seed=11)
    batch = train_batch()
    out = prog(batch['image'])
    want = detector_loss(out, common.program_config(cfg),
                         common.featmap_sizes(cfg, 128), batch['gt_bboxes'],
                         batch['gt_labels'], batch['gt_mask'], kernels=False)
    got, _ = rtrain.detector_loss(ref, batch, cfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


def test_sgd_steps_match_program():
    from r3det_tpu_torch.parallel.train import make_optimizer, make_train_step
    cfg, prog, ref = pair('r3det_r50', seed=13)
    batches = [train_batch(s) for s in (1, 2)]
    step = make_train_step(prog, common.program_config(cfg),
                           common.featmap_sizes(cfg, 128),
                           optimizer=make_optimizer(prog.parameters()),
                           device='cpu')
    want = [float(step(b)['total']) for b in batches]
    got, _, _, _ = rtrain.train_steps(ref, batches, cfg, cfg['optimizer'])
    assert got == pytest.approx(want, rel=1e-5)
    pp = dict(prog.named_parameters())
    for n, p in ref.named_parameters():
        torch.testing.assert_close(p, pp[n], rtol=1e-4, atol=1e-7, msg=n)


def test_int8_control_is_coarser():
    """The training controls (every conv in int8, or in fp8) move the
    losses."""
    cfg, _, ref = pair('r3det_r50', seed=17)
    batch = train_batch(5)
    with torch.no_grad():
        a, out = rtrain.detector_loss(ref, batch, cfg)
        for q in ('int8', 'fp8'):
            for m in ref.modules():
                m.quant = q
            b, _ = rtrain.detector_loss(ref, batch, cfg, rois=out['rois'])
            assert float(a['total']) != float(b['total'])


def test_fake_quant_steps():
    from portbench.reference.model import fake_quant
    x = torch.linspace(-3, 5, 1001, requires_grad=True)
    q8 = fake_quant(x, 'int8')
    assert (q8 - x).abs().max() <= 5 / 127 / 2 + 1e-6
    assert len(torch.unique(q8.detach())) <= 255
    f8 = fake_quant(x, 'fp8')
    big = x.abs() > 0.5
    assert ((f8 - x).abs() / x.abs())[big].max() <= 2 ** -4 + 1e-6
    f8.sum().backward()                       # straight through
    assert torch.equal(x.grad, torch.ones_like(x))


def imports_of(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for f in (PB / 'reference').rglob('*.py'):
        for mod in imports_of(f):
            assert mod.split('.')[0] not in ('r3det_tpu_torch', 'r3det_tpu',
                                             'jax', 'jaxlib', 'flax'), f
    code = ('import sys; sys.path.insert(0, %r); '
            'import portbench.reference.model, portbench.reference.predict, '
            'portbench.reference.train, portbench.work.flops; '
            'portbench.reference.model.ResNet; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"r3det_tpu_torch", "r3det_tpu", "jax", "jaxlib", "flax"}))'
            % str(PB.parent))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == '[]'
