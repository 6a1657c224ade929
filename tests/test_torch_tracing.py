"""The port's spans (``r3det_tpu_torch/utils/tracing.py``) on the CPU, in
the tiny detectors of tests/test_torch_detector.py: off they record
nothing, on they nest as the serving path's layers do, and they change no
detection."""
import numpy as np
import pytest
import torch

from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.ops import nms
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils import tracing

from program_spans import sweep_branch, traced

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
