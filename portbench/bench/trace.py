"""The traced sub-window: module spans from forward hooks, the device
trace from ``torch.profiler``, and the arithmetic on its intervals.

Spans are CUDA events recorded by the benchmark's own hooks around the
program's submodules (and by the drivers around the calls they make), so
nothing inside the program is edited. Device kernels come from the
profiler's trace; each driver's step runs inside a ``record_function``
range named ``portbench.step``, which bounds the traced window.
"""
import torch


class Spans:
    """Device-time spans (ms) of named sections, from pairs of CUDA events
    recorded on the current stream, summed per name over the steps."""

    def __init__(self):
        self.open = {}
        self.done = []
        self.hooks = []
        self.on = False

    def begin(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.open[name] = ev

    def end(self, name):
        if self.on and name in self.open:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.done.append((name, self.open.pop(name), ev))

    def hook(self, module, name):
        """Span ``name`` around every call of ``module``."""
        self.hooks.append(module.register_forward_pre_hook(
            lambda m, a: self.begin(name)))
        self.hooks.append(module.register_forward_hook(
            lambda m, a, o: self.end(name)))

    def remove(self):
        for h in self.hooks:
            h.remove()
        self.hooks = []

    def totals(self):
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.done:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def subtract_length(intervals, cover):
    """Length of ``intervals`` not covered by the union of ``cover``."""
    merged = []
    for a, b in sorted(cover):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out = 0.0
    for a, b in intervals:
        left = b - a
        for c, d in merged:
            if d <= a:
                continue
            if c >= b:
                break
            left -= min(b, d) - max(a, c)
        out += max(left, 0.0)
    return out


def gaps(intervals, start, end):
    """The idle gaps (start, end) between merged ``intervals`` inside
    [start, end]."""
    out, cur = [], start
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, end)))
        cur = max(cur, b)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]


def name_gaps(idle, host_ops, steps, top=10, longest=400):
    """Idle seconds by what the host was doing, over the ``longest`` gaps:
    each gap is named by the innermost host op that spans its midpoint,
    'python' inside a step but outside any op, 'between steps' outside
    the steps."""
    import numpy as np
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:longest]
    starts = np.array([o[0] for o in host_ops], np.float64)
    ends = np.array([o[1] for o in host_ops], np.float64)
    by = {}
    for a, b in idle:
        mid = (a + b) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(inside):
            k = inside[np.argmin(ends[inside] - starts[inside])]
            name = host_ops[k][2]
        elif any(s <= mid <= e for s, e in steps):
            name = 'python'
        else:
            name = 'between steps'
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]


class DeviceTrace:
    """What one profiled sub-window saw: device ops (name, start, end) in
    us, host ops, and the window's bounds."""

    def __init__(self, prof):
        dev, host, steps = [], [], []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name != 'portbench.step':      # the range's GPU copy
                    dev.append((e.time_range.start, e.time_range.end,
                                e.name))
            elif e.name == 'portbench.step':
                steps.append((e.time_range.start, e.time_range.end))
            else:
                host.append((e.time_range.start, e.time_range.end, e.name))
        self.device = [d for d in dev if d[1] > d[0]]
        self.host = host
        if not steps:
            raise RuntimeError('the traced window holds no step')
        last_dev = max((d[1] for d in self.device), default=steps[-1][1])
        self.start = min(s for s, _ in steps)
        self.end = max(max(e for _, e in steps), last_dev)
        self.step_ranges = steps
        self.steps = len(steps)

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def busy_s(self):
        return union_length([(a, b) for a, b, _ in self.device
                             if b > self.start and a < self.end]) / 1e6

    def by_name(self):
        out = {}
        for a, b, n in self.device:
            out[n] = out.get(n, 0.0) + (b - a) / 1e6
        return out

    def kernel_s(self, *needles):
        """Device seconds of ops whose name contains any of ``needles``."""
        return sum(s for n, s in self.by_name().items()
                   if any(k in n for k in needles))

    def breakdown(self, top=10):
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = gaps([(a, b) for a, b, _ in self.device], self.start,
                    self.end)
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': name_gaps(idle, self.host, self.step_ranges,
                                       top)}


def span_steps(run_step, steps, spans):
    """Run ``steps`` steps with ``spans`` recording (no profiler); returns
    the spans' totals (ms)."""
    spans.on = True
    for i in range(steps):
        run_step(i)
    spans.on = False
    return spans.totals()


def profile_steps(run_step, steps):
    """Run ``run_step(i)`` for ``steps`` steps under the profiler, each in
    a ``portbench.step`` range; returns the DeviceTrace and the seconds
    the steps took (the profiler's start and its processing left out)."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            with record_function('portbench.step'):
                run_step(i)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
    return DeviceTrace(prof), loop_s
