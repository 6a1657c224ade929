"""The lean sub-window's arithmetic and readers on the CPU: a synthetic
device-only trace with correlation ids under the recorder's spans, the
attribution of device ops and idle to spans, a run without the timeline,
a program without the recorder, and the sub-window itself on the tiny
serving cell."""
import sys

import pytest

from conftest import make_tiny

from portbench.bench import program_timeline, serve
from portbench.bench.manifest import Manifest
from portbench.bench.program_timeline import Timeline
from r3det_tpu_torch.utils.tracing import Record

READERS = ('backbone_dev_ms.serve', 'neck_heads_dev_ms.serve',
           'frm_dev_ms.serve', 'decode_dev_ms.serve', 'nms_dev_ms.serve',
           'step_gap_ms.serve', 'forward_gap_ms.serve',
           'decode_gap_ms.serve', 'nms_gap_ms.serve', 'h2d_mb.serve')
US = 1000                                     # ns

# one step's spans, us: (name, begin, end, parent, h2d bytes)
SPANS = [('predict', 10, 990, None, 0), ('forward', 20, 400, 0, 0),
         ('backbone', 25, 200, 1, 0), ('neck', 200, 300, 1, 0),
         ('head.s0', 300, 390, 1, 0), ('copy.anchors', 390, 395, 1, 1000),
         ('decode', 400, 500, 0, 0), ('copy.coder', 410, 420, 6, 40),
         ('nms', 500, 980, 0, 0), ('sync.budget', 520, 560, 8, 0)]
# one step's device ops, us: (start, end, launch or None); B is launched
# in the backbone and runs under the neck's host range, G has no runtime
# call, the last is the detections' copy after the predict span
OPS = [(30, 150, 26), (140, 260, 100), (265, 300, 210), (305, 380, 302),
       (420, 480, 415), (530, 600, 510), (610, 620, None), (993, 998, 992)]


def synthetic(steps=2):
    records, ops, launches = [], [], {}
    for s in range(steps):
        base = len(records)
        for name, a, b, parent, nbytes in SPANS:
            r = Record(name, s, None if parent is None else base + parent,
                       len(records))
            r.begin_ns, r.end_ns = (a + 1000 * s) * US, (b + 1000 * s) * US
            r.h2d_bytes = nbytes
            records.append(r)
        for k, (a, b, t) in enumerate(OPS):
            corr = 100 * s + k + 1
            ops.append(((a + 1000 * s) * US, (b + 1000 * s) * US, corr))
            if t is not None:
                launches[corr] = (t + 1000 * s) * US
    return Timeline(records, sorted(ops), launches)


def read_all(run):
    man = Manifest()
    return {n: man.reader({'name': n})(run) for n in READERS}


def test_ops_go_to_their_launching_span():
    """Each op's part that no earlier op covers goes to the innermost span
    over its runtime call (B to the backbone, though it runs under the
    neck's range), an op launched after the predict span to 'outside', one
    without a call to 'unlaunched'; they add up to the busy time."""
    tl = synthetic()
    want = {'r3det.backbone': 120 + 110, 'r3det.neck': 35,
            'r3det.head.s0': 75, 'r3det.copy.coder': 60, 'r3det.nms': 70,
            'outside': 5, 'unlaunched': 10}
    assert tl.by_span('device') == {n: 2 * us * US for n, us in want.items()}
    assert tl.busy_ns == sum(tl.by_span('device').values()) == 2 * 485 * US


def test_idle_by_span_adds_up_to_the_window():
    """The window runs from the first predict span's begin to the last
    op's end; its idle, gap by gap under the innermost span, adds up to
    the window less the busy time."""
    tl = synthetic()
    idle = tl.by_span('idle')
    assert sum(idle.values()) == tl.idle_total_ns
    assert tl.idle_total_ns == (1998 - 10) * US - tl.busy_ns
    per_step = {'r3det.predict': 10 + 10, 'r3det.forward': 5 + 5,
                'r3det.backbone': 5, 'r3det.neck': 5, 'r3det.head.s0': 5 + 10,
                'r3det.copy.anchors': 5, 'r3det.decode': 10 + 20,
                'r3det.copy.coder': 10, 'r3det.nms': 20 + 10 + 360,
                'r3det.sync.budget': 10}
    assert idle == {**{n: 2 * us * US for n, us in per_step.items()},
                    'outside': (3 + 12 + 3) * US}


def test_readers_on_the_synthetic_window():
    got = read_all({'program_timeline': synthetic()})
    assert got == pytest.approx({
        'backbone_dev_ms.serve': 0.23, 'neck_heads_dev_ms.serve': 0.11,
        'frm_dev_ms.serve': None, 'decode_dev_ms.serve': 0.06,
        'nms_dev_ms.serve': 0.07, 'step_gap_ms.serve': 1018 / 2 / 1e3,
        'forward_gap_ms.serve': 0.04, 'decode_gap_ms.serve': 0.04,
        'nms_gap_ms.serve': 0.4, 'h2d_mb.serve': 1040 / 1e6})


def test_no_timeline_no_reading():
    for run in ({'program_timeline': None}, {}):
        assert all(v is None for v in read_all(run).values())


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """What ``cli.execute`` hands the readers of a traced run of the tiny
    serving cell, with ``run.py``'s arguments on the command line."""
    import torch
    torch.set_num_threads(2)
    man = make_tiny(tmp_path)
    cell = man.cell('tiny_r3det.serve')
    monkeypatch.setattr(sys, 'argv', [
        'run.py', '--workload', cell['name'], '--seed', str(2 ** 31 + 77),
        '--seconds', '1', '--trace', '1'])
    traffic = man.traffic(cell['traffic'])
    return dict(cfg=man.config(cell['config']), traffic=traffic,
                steps=traffic['trace_steps'], traced_s=1.0,
                res={'e2e': {'patches_per_s': 4.0}})


def test_program_without_the_recorder_gives_nothing(tiny_run, monkeypatch):
    """The parent's program: a tracing module without ``records``. No
    sub-window is built and every new metric is left out."""
    from r3det_tpu_torch.utils import tracing
    monkeypatch.delattr(tracing, 'records')

    def no_build(*a, **k):
        raise AssertionError('built a program without the recorder')

    monkeypatch.setattr(serve, 'build', no_build)
    assert all(v is None for v in read_all(tiny_run).values())
    assert tiny_run['program_timeline'] is None


def test_sub_window_on_the_tiny_cell(tiny_run, capsys):
    """Without a card the sub-window runs its steps with the recorder on
    and no profiler, once: one ``[program_timeline]`` line with the rate
    and the bytes, and nothing for the readers."""
    from r3det_tpu_torch.utils import tracing
    assert all(v is None for v in read_all(tiny_run).values())
    assert not tracing.enabled() and tracing.records() == []
    err = capsys.readouterr().err
    assert err.count('[program_timeline]') == 1
    line = next(x for x in err.splitlines()
                if x.startswith('[program_timeline]'))
    fields = dict(f.split('=', 1) for f in line.split()[1:])
    assert fields['steps'] == str(tiny_run['traffic']['trace_steps'])
    assert float(fields['patches_per_s']) > 0
    assert float(fields['h2d_bytes_per_step']) > 0
    assert 'device_ms_by_span' not in fields
    assert read_all(tiny_run) == dict.fromkeys(READERS)
    assert capsys.readouterr().err.count('[program_timeline]') == 0


def test_no_seed_no_window(tiny_run, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['run.py'])
    assert program_timeline.timeline(tiny_run) is None
