"""The program's own spans on the device trace's axis, in a lean traced
sub-window of their own.

The program's recorder (``r3det_tpu_torch/utils/tracing.py``) stamps each
span on the profiler's host clock and keeps it in memory. Here the
profiler records device activity alone (``ProfilerActivity.CUDA``): the
device ops and the runtime calls that launched them, linked by Kineto's
correlation id, and no host op, so the host runs nearer its own speed
than under the CPU-activity profiler of the other sub-windows. Each device
op is put down to the innermost span whose host range holds the runtime
call that launched it; each stretch of the window's device idle to the
innermost span over it, ``outside`` under none (the rule of
``program_spans.idle_by_span``).

The first reader that asks builds the sub-window after the others: the
cell's program anew from the run's own ``--seed`` (``serve.build``),
warmed up as set-up does, then the traffic's ``trace_steps`` steps with
the recorder on. It keeps the :class:`Timeline` in the run
(``run['program_timeline']``) for the other readers and logs one
``[program_timeline]`` line: the window's rate beside the untraced
window's and the profiled sub-windows', device and idle ms a step by span,
and the host-to-device bytes a step. Without a card the steps run with no
profiler, the line has no device numbers and the readers get None; a
program without the recorder makes no sub-window.
"""
import bisect
import time

import torch

from . import common, serve
from .program_spans import run_seed
from .trace import gaps

PREFIX = 'r3det.'


def kineto_ops(prof):
    """A device-only trace's device ops [(start ns, end ns, correlation id)]
    sorted, and the start (ns) of the runtime call of each correlation
    id."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        start, corr = e.start_ns(), e.correlation_id()
        if e.device_type() == cuda:
            if e.duration_ns() > 0:
                ops.append((start, start + e.duration_ns(), corr))
        elif corr:
            launches.setdefault(corr, start)
    ops.sort()
    return ops, launches


class Timeline:
    """The recorder's spans (``tracing.Record``) of a window's predict
    steps with the device ops of a device-only trace: each span's device
    ns (the ops it launched innermost, each op counted for the part of its
    interval no earlier op covers, so that the spans add up to the busy
    time) and idle ns (the gaps it lies innermost over), and those of no
    span (``outside``) or of ops without a launching call
    (``unlaunched``)."""

    def __init__(self, records, ops, launches):
        self.records = [r for r in records if r.end_ns is not None]
        steps = [r for r in self.records if r.name == 'predict']
        if not steps:
            raise ValueError('the window holds no predict span')
        self.steps = len(steps)
        self.start = min(r.begin_ns for r in steps)
        self.end = max([r.end_ns for r in steps] + [b for _, b, _ in ops])
        self.cuts, self.owner = cuts, owner = self._innermost()
        n = max(r.index for r in self.records) + 1
        self.device_ns, self.idle_ns = [0] * n, [0] * n
        self.outside = {'device': 0, 'idle': 0}
        self.unlaunched_ns = 0
        covered = self.start
        for a, b, corr in ops:
            lo, hi = max(a, covered), min(b, self.end)
            covered = max(covered, b)
            if hi <= lo:
                continue
            t = launches.get(corr)
            k = None if t is None else self.owner_at(t)
            if t is None:
                self.unlaunched_ns += hi - lo
            elif k is None:
                self.outside['device'] += hi - lo
            else:
                self.device_ns[k] += hi - lo
        for a, b in gaps([(a, b) for a, b, _ in ops], self.start, self.end):
            i = bisect.bisect_right(cuts, a) - 1
            while a < b:
                stop = min(b, cuts[i + 1])
                k = owner[i]
                if k is None:
                    self.outside['idle'] += stop - a
                else:
                    self.idle_ns[k] += stop - a
                a, i = stop, i + 1

    def _innermost(self):
        """The window cut at every span's bounds, and the index of the
        shortest span over each stretch (None under none)."""
        cuts = sorted({self.start, self.end} | {
            t for r in self.records for t in (r.begin_ns, r.end_ns)
            if self.start < t < self.end})
        owner, length = [None] * (len(cuts) - 1), [0] * (len(cuts) - 1)
        for r in self.records:
            span = r.end_ns - r.begin_ns
            for i in range(bisect.bisect_left(cuts, r.begin_ns),
                           bisect.bisect_left(cuts, r.end_ns)):
                if owner[i] is None or span < length[i]:
                    owner[i], length[i] = r.index, span
        return cuts, owner

    def owner_at(self, t):
        """The index of the innermost span over the time ``t`` (ns), None
        under none."""
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.owner[i] if 0 <= i < len(self.owner) else None

    @property
    def busy_ns(self):
        return (sum(self.device_ns) + self.outside['device']
                + self.unlaunched_ns)

    @property
    def idle_total_ns(self):
        return sum(self.idle_ns) + self.outside['idle']

    def by_span(self, kind):
        """{'r3det.<name>': ns, 'outside': ns} of ``kind`` ('device' or
        'idle'), each span's own (innermost) part, over the window."""
        vals = self.device_ns if kind == 'device' else self.idle_ns
        out = {}
        for r in self.records:
            if vals[r.index]:
                key = PREFIX + r.name
                out[key] = out.get(key, 0) + vals[r.index]
        if self.outside[kind]:
            out['outside'] = self.outside[kind]
        if kind == 'device' and self.unlaunched_ns:
            out['unlaunched'] = self.unlaunched_ns
        return out

    def under(self, kind, *names):
        """ns of ``kind`` over the window in the spans named ``names``
        (``r3det.<name>``, or a prefix ending in '.') and every span inside
        them; None where no span has such a name."""
        byindex = {r.index: r for r in self.records}

        def hit(r):
            while r is not None:
                full = PREFIX + r.name
                if any(full == n or (n.endswith('.') and full.startswith(n))
                       for n in names):
                    return True
                r = byindex.get(r.parent)
            return False
        inside = [r.index for r in self.records if hit(r)]
        if not inside:
            return None
        vals = self.device_ns if kind == 'device' else self.idle_ns
        return sum(vals[i] for i in inside)

    def h2d_bytes(self):
        return sum(r.h2d_bytes for r in self.records)


def _ms_by_span(ns, steps):
    return sorted(([n, v / 1e6 / steps] for n, v in ns.items()),
                  key=lambda x: -x[1])


def window(run, seed, device):
    """The lean sub-window of the run's cell: its Timeline, or None without
    a card or for a program without the recorder."""
    try:
        from r3det_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not hasattr(tracing, 'records'):
        return None
    traffic = run['traffic']
    b = serve.build(run['cfg'], traffic, seed, device)
    step, pool = b['step'], b['pool']
    b.clear()

    def run_step(i):
        dets, labels, num = step(pool[i % len(pool)])
        (dets.cpu(), labels.cpu(), num.cpu())

    for i in range(len(pool) + 1):                       # warm-up
        run_step(i)
    steps = traffic['trace_steps']
    card = device.type == 'cuda'
    tracing.enable(True)
    try:
        if card:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for i in range(steps):
                    run_step(i)
                torch.cuda.synchronize()
                loop_s = time.perf_counter() - t
        else:
            t = time.perf_counter()
            for i in range(steps):
                run_step(i)
            loop_s = time.perf_counter() - t
        records = tracing.records()
    finally:
        tracing.enable(False)
    del step, pool
    if card:
        torch.cuda.empty_cache()
    tl = Timeline(records, *kineto_ops(prof)) if card else None
    batch = traffic['batch']
    rate = steps * batch / loop_s
    untraced = run.get('res', {}).get('e2e', {}).get('patches_per_s')
    spans_tr = run.get('program_trace')
    fields = dict(
        steps=steps, patches_per_s=rate, untraced_patches_per_s=untraced,
        ratio_to_untraced=None if not untraced else rate / untraced,
        profiled_patches_per_s=run['steps'] * batch / run['traced_s'],
        program_spans_patches_per_s=None if spans_tr is None
        else spans_tr.steps * batch / spans_tr.window_s,
        spans=len(records),
        h2d_bytes_per_step=sum(r.h2d_bytes for r in records) / steps)
    if tl is not None:
        fields.update(
            window_ms=(tl.end - tl.start) / 1e6 / tl.steps,
            busy_ms=tl.busy_ns / 1e6 / tl.steps,
            idle_ms=tl.idle_total_ns / 1e6 / tl.steps,
            unlaunched_ms=tl.unlaunched_ns / 1e6 / tl.steps,
            device_ms_by_span=_ms_by_span(tl.by_span('device'), tl.steps),
            idle_ms_by_span=_ms_by_span(tl.by_span('idle'), tl.steps))
    common.log('program_timeline', **fields)
    return tl


def timeline(run):
    """The run's lean sub-window, made by the first reader that asks; None
    without a card or the recorder, or outside ``run.py``."""
    if 'program_timeline' not in run:
        seed = run_seed()
        device = torch.device('cuda', torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device('cpu')
        run['program_timeline'] = None if seed is None or 'cfg' not in run \
            else window(run, seed, device)
    return run['program_timeline']


def stage_ms(run, kind, *names):
    """ms a predict step of ``kind`` ('device' or 'idle') in the spans
    ``names`` and the spans inside them; None without the lean sub-window
    or such a span."""
    tl = timeline(run)
    if tl is None:
        return None
    ns = tl.under(kind, *names)
    return None if ns is None else ns / 1e6 / tl.steps


def step_gap_ms(run):
    """The lean sub-window's device idle ms a predict step; None without
    it."""
    tl = timeline(run)
    return None if tl is None else tl.idle_total_ns / 1e6 / tl.steps


def h2d_mb(run):
    """Host-to-device MB (1e6 bytes) a predict step that the program's
    ``copy.*`` sites counted in the lean sub-window; None without it."""
    tl = timeline(run)
    return None if tl is None else tl.h2d_bytes() / 1e6 / tl.steps
