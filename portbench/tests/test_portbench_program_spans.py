"""The span readers and their sub-window on the CPU: the arithmetic on a
synthetic program-traced window with the GPU copies of user ranges among
its device ops, the attribution of the window's idle, a program without
spans, and the sub-window itself on the tiny serving cell."""
import sys

import pytest

from conftest import make_tiny

from portbench.bench import program_spans, serve, trace
from portbench.bench.manifest import Manifest

READERS = ('forward_idle_ms.serve', 'decode_idle_ms.serve',
           'nms_idle_ms.serve', 'host_syncs.serve', 'host_transfer_ms.serve')


def read_all(run):
    man = Manifest()
    return {n: man.reader({'name': n})(run) for n in READERS}


def synthetic(steps=2):
    """A program-traced sub-window of ``steps`` steps of 1000 us, each with
    the same host ranges and device ops, and the GPU copies of user
    ranges among the device ops."""
    host = [('r3det.predict', 10, 990), ('r3det.forward', 20, 400),
            ('r3det.copy.anchors', 50, 80), ('r3det.decode', 400, 500),
            ('r3det.copy.coder', 410, 420), ('r3det.nms', 500, 980),
            ('r3det.sync.budget', 520, 560),
            ('r3det.nms.sweep.big', 570, 970),
            ('r3det.sync.fixpoint', 600, 650),
            ('r3det.sync.fixpoint', 700, 720), ('aten::copy_', 52, 78)]
    device = [('k', 30, 300), ('k', 390, 410), ('k', 450, 480),
              ('rotated_iou_kernel', 530, 600),
              ('r3det.predict', 15, 995), ('r3det.nms', 505, 985),
              ('portbench.step', 5, 999)]
    tr = trace.DeviceTrace.__new__(trace.DeviceTrace)
    tr.host = [(a + 1000 * i, b + 1000 * i, n)
               for i in range(steps) for n, a, b in host]
    tr.device = [(a + 1000 * i, b + 1000 * i, n)
                 for i in range(steps) for n, a, b in device]
    tr.step_ranges = [(1000 * i, 1000 * i + 1000) for i in range(steps)]
    tr.start, tr.end, tr.steps = 0.0, 1000.0 * steps, steps
    return tr


@pytest.mark.parametrize('steps', [1, 2])
def test_span_readers(steps):
    """Each step: forward idle [20, 30] + [300, 390] us, decode [410, 450]
    + [480, 500], nms [500, 530] + [600, 980]; three syncs; syncs and
    copies 150 us of host time; the GPU copies count as no device work."""
    assert read_all({'program_trace': synthetic(steps)}) == pytest.approx({
        'forward_idle_ms.serve': 0.1, 'decode_idle_ms.serve': 0.06,
        'nms_idle_ms.serve': 0.41, 'host_syncs.serve': 3.0,
        'host_transfer_ms.serve': 0.15})
    for run in ({'program_trace': None}, {}):
        assert all(v is None for v in read_all(run).values())
    tr = synthetic(steps)
    tr.host = [h for h in tr.host if h[2] != 'r3det.predict']
    assert all(v is None for v in read_all({'program_trace': tr}).values())


def test_idle_by_span_is_complete():
    """The window's idle by the innermost span over each stretch, and
    'outside', adds up to the window's idle as DeviceTrace computes it
    without the GPU copies; the layers' readers and the rest of
    ``r3det.predict`` add up to it as well."""
    tr = synthetic()
    idle = program_spans.idle_by_span(tr)
    per_step = {'r3det.forward': 100, 'r3det.decode': 50,
                'r3det.copy.coder': 10, 'r3det.nms': 30,
                'r3det.sync.budget': 10, 'r3det.nms.sweep.big': 300,
                'r3det.sync.fixpoint': 70, 'r3det.predict': 20,
                'outside': 20}
    assert idle == pytest.approx({n: 2 * us / 1e6
                                  for n, us in per_step.items()})
    clean = synthetic()
    clean.device = [d for d in clean.device
                    if not d[2].startswith(('r3det.', 'portbench.'))]
    window_idle = clean.window_s - clean.busy_s()
    assert sum(idle.values()) == pytest.approx(window_idle)
    got = read_all({'program_trace': tr})
    layers = sum(got[n] for n in ('forward_idle_ms.serve',
                                  'decode_idle_ms.serve', 'nms_idle_ms.serve'))
    rest = idle['r3det.predict'] + idle['outside']
    assert layers * 2 / 1e3 + rest == pytest.approx(window_idle)


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """What ``cli.execute`` hands the readers of a traced run of the tiny
    serving cell, with ``run.py``'s arguments on the command line; the
    profiler's card syncs are no-ops on the CPU."""
    import torch
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    man = make_tiny(tmp_path)
    cell = man.cell('tiny_r3det.serve')
    monkeypatch.setattr(sys, 'argv', [
        'run.py', '--workload', cell['name'], '--seed', str(2 ** 31 + 77),
        '--seconds', '1', '--trace', '1'])
    traffic = man.traffic(cell['traffic'])
    return dict(cfg=man.config(cell['config']), traffic=traffic,
                steps=traffic['trace_steps'], traced_s=1.0, res={})


def test_program_without_spans_gives_nothing(tiny_run, monkeypatch):
    """The parent's program, which has no tracing module: no sub-window is
    built and every span metric is left out."""
    import r3det_tpu_torch.utils as utils
    monkeypatch.setitem(sys.modules, 'r3det_tpu_torch.utils.tracing', None)
    monkeypatch.delattr(utils, 'tracing', raising=False)

    def no_build(*a, **k):
        raise AssertionError('built a program without spans')

    monkeypatch.setattr(serve, 'build', no_build)
    assert all(v is None for v in read_all(tiny_run).values())
    assert tiny_run['program_trace'] is None


def test_sub_window_on_the_tiny_cell(tiny_run, capsys):
    """The first reader builds the sub-window once, with the spans on in
    it alone; one ``r3det.predict`` a step, the layers inside it."""
    from r3det_tpu_torch.utils import tracing
    got = read_all(tiny_run)
    tr = tiny_run['program_trace']
    steps = tiny_run['traffic']['trace_steps']
    assert not tracing.enabled()
    assert len(program_spans.ranges(tr, 'r3det.predict')) == steps
    for name in ('r3det.forward', 'r3det.decode', 'r3det.nms'):
        assert len(program_spans.ranges(tr, name)) == steps
    assert all(v is not None and v >= 0 for v in got.values())
    assert got['host_syncs.serve'] >= 1
    err = capsys.readouterr().err
    assert err.count('[program_idle]') == 1
    assert err.count('[program_tracing_overhead]') == 1
    assert read_all(tiny_run) == got


def test_no_seed_no_window(tiny_run, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['run.py'])
    assert program_spans.program_trace(tiny_run) is None
