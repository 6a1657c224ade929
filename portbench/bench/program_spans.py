"""The program's own spans (``r3det_tpu_torch/utils/tracing.py``) in a
profiled sub-window of their own, and the arithmetic their readers share.

Each span is a host range ``r3det.<name>`` and, like ``portbench.step``,
has a GPU copy among the profiler's device ops. The serving driver's
traced sub-windows run with the spans off, so that no reader of theirs
counts those copies as device work. The first span reader of a traced run
makes this sub-window after them: it builds the cell's program anew from
the run's own ``--seed`` (``serve.build``), warms it up as set-up does,
runs the traffic's ``trace_steps`` steps under the profiler with the spans
on, and keeps the DeviceTrace in the run (``run['program_trace']``) for
the other readers. It logs ``[program_tracing_overhead]`` (its rate
against the driver's profiled sub-window) and ``[program_idle]`` (the
window's idle by the innermost span over it). A program without the
tracing module makes no sub-window, and its span metrics are left out.
"""
import argparse
import bisect
import sys

import torch

from . import common, serve
from .trace import gaps, name_gaps, profile_steps


def device_ops(trace):
    """The device ops' (start, end) of a program-traced sub-window, sorted,
    without the GPU copies of user ranges."""
    return sorted((a, b) for a, b, n in trace.device
                  if not n.startswith('r3det.') and n != 'portbench.step')


def ranges(trace, name):
    """The host ranges (start, end) of the spans named ``name`` or, for a
    ``name`` ending in '.', starting with it."""
    return [(a, b) for a, b, n in trace.host
            if n == name or (name.endswith('.') and n.startswith(name))]


def idle_inside(device, spans):
    """Device-idle us inside ``spans``: each span's length less the union
    of the sorted ``device`` intervals inside it."""
    return sum(b - a for s, e in spans for a, b in gaps(device, s, e))


def idle_by_span(trace):
    """The window's idle seconds by the innermost ``r3det.*`` range over
    each stretch of each gap ('outside' under none); they add up to the
    window's idle."""
    spans = [r for r in trace.host if r[2].startswith('r3det.')]
    cuts = sorted({trace.start, trace.end} | {
        t for a, b, _ in spans for t in (a, b)
        if trace.start < t < trace.end})
    # each stretch between cuts: the shortest range that covers it
    owner = [None] * (len(cuts) - 1)
    for a, b, n in spans:
        for i in range(bisect.bisect_left(cuts, a),
                       bisect.bisect_left(cuts, b)):
            if owner[i] is None or b - a < owner[i][0]:
                owner[i] = (b - a, n)
    out = {}
    for a, b in gaps(device_ops(trace), trace.start, trace.end):
        i = bisect.bisect_right(cuts, a) - 1
        while a < b:
            stop = min(b, cuts[i + 1])
            name = owner[i][1] if owner[i] else 'outside'
            out[name] = out.get(name, 0.0) + (stop - a) / 1e6
            a, i = stop, i + 1
    return out


def run_seed():
    """The ``--seed`` that ``run.py`` was given, or None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument('--seed', type=int)
    return p.parse_known_args(sys.argv[1:])[0].seed


def window(run, seed, device):
    """The program-traced sub-window of the run's cell: its DeviceTrace, or
    None for a program without spans."""
    try:
        from r3det_tpu_torch.utils import tracing
    except ImportError:
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
    tracing.enable(True)
    try:
        trace, loop_s = profile_steps(run_step, steps)
    finally:
        tracing.enable(False)
    del step, pool
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    rate = steps * traffic['batch'] / loop_s
    before = run['steps'] * traffic['batch'] / run['traced_s']
    common.log('program_tracing_overhead', profiled_patches_per_s=before,
               program_traced_patches_per_s=rate, overhead=1 - rate / before)
    idle = idle_by_span(trace)
    host_ops = [h for h in trace.host if not h[2].startswith('r3det.')]
    common.log('program_idle', steps=steps, window_s=trace.window_s,
               idle_s=sum(idle.values()),
               by_span=sorted(([n, s] for n, s in idle.items()),
                              key=lambda x: -x[1]),
               gaps_by_host_op=name_gaps(
                   gaps(device_ops(trace), trace.start, trace.end),
                   host_ops, trace.step_ranges))
    return trace


def program_trace(run):
    """The run's program-traced sub-window, made by the first reader that
    asks; None without the tracing module or outside ``run.py``."""
    if 'program_trace' not in run:
        seed = run_seed()
        device = torch.device('cuda', torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device('cpu')
        run['program_trace'] = None if seed is None or 'cfg' not in run \
            else window(run, seed, device)
    return run['program_trace']


def steps_of(run):
    """The run's program trace and its number of predict steps
    (``r3det.predict`` ranges); 0 steps where the program has no spans."""
    tr = program_trace(run)
    return tr, len(ranges(tr, 'r3det.predict')) if tr else 0


def span_idle_ms(run, name):
    """Device-idle ms a predict step inside the spans ``name``; None where
    the program has no spans."""
    tr, steps = steps_of(run)
    if not steps:
        return None
    return idle_inside(device_ops(tr), ranges(tr, name)) / 1e3 / steps
