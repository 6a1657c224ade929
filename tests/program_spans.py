"""Reading the port's spans (``r3det_tpu_torch/utils/tracing.py``) in the
tests: a call under a CPU ``torch.profiler`` with tracing on."""
from torch.profiler import ProfilerActivity, profile

from r3det_tpu_torch.utils import tracing


def profiled(fn, on=True):
    """``fn()`` under a CPU profiler with the spans ``on`` (tracing is off
    again afterwards): its result and the profiler."""
    tracing.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        tracing.enable(False)
    return out, prof


def traced(fn, on=True):
    """``fn()`` under a CPU profiler with the spans ``on``: its result and
    the ``r3det.*`` ranges, (name, start us, end us) in start order."""
    out, prof = profiled(fn, on)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith('r3det.')),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def traced_ns(fn):
    """``fn()`` under a CPU profiler with the spans on: its result, the
    ``r3det.*`` ranges (name, start ns, end ns) on the profiler's clock in
    start order, and the recorder's records."""
    out, prof = profiled(fn)
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith('r3det.')),
                   key=lambda s: (s[1], -s[2]))
    return out, spans, tracing.records()


def sweep_branch(spans):
    """The adaptive NMS budget's branches, one a sweep, from the names of
    the ``r3det.nms.sweep.*`` spans."""
    return [n.rsplit('.', 1)[1] for n, _, _ in spans
            if n.startswith('r3det.nms.sweep.')]
