"""The port's spans (``r3det_tpu_torch/utils/tracing.py``) on the CPU, in
the tiny detectors of tests/test_torch_detector.py: off they record
nothing, on they nest as the serving path's layers do, the recorder's
records match the profiler's ranges on its clock, the ``copy.*`` sites
count their bytes, and the spans change no detection."""
import gc
import statistics

import numpy as np
import pytest
import torch

from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.ops import nms
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils import tracing

from program_spans import sweep_branch, traced, traced_ns

torch.set_num_threads(2)

FEATMAP_SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
TEST = T.TestCfg(nms_pre=64, max_per_img=16)
R3DET = T.DetectorConfig(num_classes=3, stacked_convs=2, feat_channels=32,
                         backbone_depth=10, num_refine_stages=1, test=TEST)
# each NMS budget branch: (detector, final cls bias, test_cfg overrides);
# with the final cls weights scaled up 100 times, 'small' and 'big' send
# fewer and more live candidates than small_k = 64 to a budget of 128,
# 'single' has a budget no larger than small_k
CASES = {'big': (R3DET, 4.0, {}),
         'small': (R3DET, -5.0, {}),
         'single': (R3DET._replace(num_refine_stages=0), 4.0,
                    {'nms_candidates': 64})}
STEPS = 2


def inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def within(spans, outer, prefix):
    return [s for s in spans if s is not outer and s[0].startswith(prefix)
            and inside(outer, s)]


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
    cfg, bias, test = CASES[request.param]
    cfg = cfg._replace(test=cfg.test._replace(**test))
    torch.manual_seed(0)
    model = T.build_detector(cfg, dtype=torch.float32, device='cpu')
    head = 'refine_head_0' if cfg.num_refine_stages else 'bbox_head'
    with torch.no_grad():
        getattr(model, head).retina_cls.weight.mul_(100)
        getattr(model, head).retina_cls.bias.fill_(bias)
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    step = make_predict_step(model, cfg, FEATMAP_SIZES)
    return dict(branch=request.param, cfg=cfg, step=step, images=images)


def run_steps(case):
    return [case['step'](case['images']) for _ in range(STEPS)]


def test_off_records_nothing(case):
    assert not tracing.enabled()
    assert tracing.span('predict') is tracing.span('nms')
    _, spans = traced(lambda: run_steps(case), on=False)
    assert spans == []


def test_on_spans_nest_as_the_layers(case, monkeypatch):
    calls = []
    real = T.level_anchors
    monkeypatch.setattr(T, 'level_anchors',
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    _, spans = traced(lambda: run_steps(case))
    names = [n for n, _, _ in spans]
    steps = [s for s in spans if s[0] == 'r3det.predict']
    assert len(steps) == STEPS
    cfg, t = case['cfg'], case['cfg'].test
    kb = min(t.nms_candidates or 2 * t.nms_pre,
             sum(h * w for h, w in FEATMAP_SIZES) * cfg.num_anchors
             * cfg.num_classes)
    k = {'big': kb, 'small': max(t.max_per_img, t.nms_pre),
         'single': kb}[case['branch']]
    for step in steps:
        layers = [s for s in within(spans, step, 'r3det.')
                  if s[0] in ('r3det.forward', 'r3det.decode', 'r3det.nms')]
        assert [s[0] for s in layers] == ['r3det.forward', 'r3det.decode',
                                          'r3det.nms']
        assert layers[0][2] <= layers[1][1] and layers[1][2] <= layers[2][1]
        nms_span = layers[2]
        sweeps = within(spans, nms_span, 'r3det.nms.sweep.')
        assert sweep_branch(sweeps) == [case['branch']]
        budget = within(spans, nms_span, 'r3det.sync.budget')
        assert len(budget) == (case['branch'] != 'single')
        fixpoint = within(spans, sweeps[0], 'r3det.sync.fixpoint')
        assert len(fixpoint) >= -(-k // nms.BLOCK_S)
        assert within(spans, layers[1], 'r3det.copy.coder')
    assert len(calls) == STEPS
    assert names.count('r3det.copy.anchors') == len(calls)
    assert not tracing.enabled()


def test_off_makes_no_record(case, monkeypatch):
    """Off, the span sites and the byte counter make no record: the
    recorder's list stays empty."""
    def made(*a, **k):
        raise AssertionError('a record was made with tracing off')

    tracing.records()                      # what an earlier test left
    monkeypatch.setattr(tracing.Record, '__init__', made)
    run_steps(case)
    assert tracing.records() == []


def test_records_match_the_profiler_ranges(case):
    """On, under a CPU profiler: one record a ``record_function`` range,
    in name, order and nesting (each record's parent is the innermost range
    over its range), each begin within 50 us of its range's on the
    profiler's clock; a predict span's records share its step. The
    process can lose the CPU between the range's stamp and the record's,
    so the clocks must agree within 50 us at the median of every call and
    at every span of one call in three, with the collector off."""
    worst = []
    gc.disable()
    try:
        for _ in range(3):
            _, spans, recs = traced_ns(lambda: run_steps(case))
            gaps = [abs(r.begin_ns - a) for (_, a, _), r in zip(spans, recs)]
            assert statistics.median(gaps) <= 50_000
            worst.append(max(gaps))
            if worst[-1] <= 50_000:
                break
    finally:
        gc.enable()
    assert min(worst) <= 50_000
    assert [n for n, _, _ in spans] == ['r3det.' + r.name for r in recs]
    for i, (_, a, b) in enumerate(spans):
        over = [j for j, (_, c, d) in enumerate(spans)
                if j != i and c <= a and b <= d]
        inner = min(over, key=lambda j: spans[j][2] - spans[j][1],
                    default=None)
        assert recs[i].parent == inner
        assert recs[i].begin_ns <= recs[i].end_ns
    steps = [r for r in recs if r.name == 'predict']
    assert [r.step for r in steps] == list(range(STEPS))
    for r in recs:
        assert r.step == (r.step if r.parent is None
                          else recs[r.parent].step)


def test_stage_spans_nest_under_forward(case):
    """The detector's stages are spans under ``forward``, in the order the
    work runs: ``backbone``, ``neck``, ``head.s0`` and, for R3Det, each
    refine stage's ``frm.<i>`` and ``head.sr<i>``."""
    _, _, recs = traced_ns(lambda: run_steps(case))
    stages = ['backbone', 'neck', 'head.s0'] + [
        n for i in range(case['cfg'].num_refine_stages)
        for n in (f'frm.{i}', f'head.sr{i}')]
    forwards = [r for r in recs if r.name == 'forward']
    assert len(forwards) == STEPS
    for f in forwards:
        assert [r.name for r in recs
                if r.parent == f.index and r.name in stages] == stages
    assert not any(r.name in stages for r in recs
                   if r.parent is None or recs[r.parent].name != 'forward')


def test_copy_sites_count_their_bytes(case):
    """``copy.anchors`` counts the anchors' bytes and ``copy.coder`` the
    coder's means and stds (five f32 each): a step holds no other bytes."""
    _, _, recs = traced_ns(lambda: run_steps(case))
    anchors = sum(a.nbytes for a in T.level_anchors(case['cfg'],
                                                    FEATMAP_SIZES, 'cpu'))
    copies = [r for r in recs if r.name.startswith('copy.')]
    assert copies
    for r in copies:
        assert r.h2d_bytes == (anchors if r.name == 'copy.anchors'
                               else 2 * 5 * 4)
    assert sum(r.h2d_bytes for r in recs) == sum(r.h2d_bytes
                                                 for r in copies)


def test_on_changes_no_detection(case):
    off = run_steps(case)
    on, spans = traced(lambda: run_steps(case))
    assert spans
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert (off[0][2] > 0).all()


def test_enable_false_after_an_exception_leaves_tracing_off():
    tracing.enable(True)
    try:
        with pytest.raises(RuntimeError):
            with tracing.span('predict'):
                raise RuntimeError('inside a span')
    finally:
        tracing.enable(False)
    assert not tracing.enabled()
    assert tracing.span('predict') is tracing.span('forward')
