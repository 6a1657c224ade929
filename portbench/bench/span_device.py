"""Device time inside the GPU copies of the program's spans: the union of
the device ops that lie inside the ranges of a name, in the
program-traced sub-window (``program_spans``)."""
import bisect

from . import program_spans
from .trace import union_length


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(ops, windows):
    """The parts of ``ops`` (start, end) inside the union of ``windows``."""
    win = merged(windows)
    starts = [a for a, _ in win]
    out = []
    for a, b in ops:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(win) and win[i][0] < b:
            lo, hi = max(a, win[i][0]), min(b, win[i][1])
            if hi > lo:
                out.append((lo, hi))
            i += 1
    return out


def inside_ms(run, name):
    """Device ms a predict step inside the GPU copies of the ``name``
    ranges; None where the program has no spans or no such range."""
    tr, steps = program_spans.steps_of(run)
    if not steps:
        return None
    windows = [(a, b) for a, b, n in tr.device if n == name]
    if not windows:
        return None
    ops = program_spans.device_ops(tr)
    return union_length(clipped(ops, windows)) / 1e3 / steps
