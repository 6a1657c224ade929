"""Reading the port's spans (``r3det_tpu_torch/utils/tracing.py``) in the
tests: a call under a CPU ``torch.profiler`` with tracing on."""
from torch.profiler import ProfilerActivity, profile

from r3det_tpu_torch.utils import tracing


def traced(fn, on=True):
    """``fn()`` under a CPU profiler with the spans ``on`` (tracing is off
    again afterwards): its result and the ``r3det.*`` ranges, (name,
    start us, end us) in start order."""
    tracing.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        tracing.enable(False)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith('r3det.')),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def sweep_branch(spans):
    """The adaptive NMS budget's branches, one a sweep, from the names of
    the ``r3det.nms.sweep.*`` spans."""
    return [n.rsplit('.', 1)[1] for n, _, _ in spans
            if n.startswith('r3det.nms.sweep.')]
