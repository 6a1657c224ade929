"""The port's spans: a recorder at the serving path's layer boundaries,
switched by one flag.

Off (the default), :func:`span` hands back one shared no-op context, so a
span site costs one flag check, and :func:`count_h2d` only that check.

On, each span appends a :class:`Record` to an in-memory list that
:func:`records` hands back: its name, its begin and end in ns on the
profiler's host clock (the realtime clock, read as the monotonic clock
plus the offset taken when tracing turned on, so that the window cannot
jump with a clock step), its step (the ordinal of the enclosing
``predict`` span), its parent's index and the host-to-device bytes that
the ``copy.*`` sites counted inside it. Nothing is written to disk.

Under a profiler that records CPU ops, each span is besides a
``torch.profiler.record_function`` range named ``r3det.<name>``, which
the profiler nests by containment and exports with
``export_chrome_trace``. Under a profiler of device activity alone a span
enters no such range: the records are placed on the device trace's axis
by their timestamps instead.

    from r3det_tpu_torch.utils import tracing
    tracing.enable(True)
    with torch.profiler.profile() as prof:
        step(images)
    tracing.enable(False)
    spans = tracing.records()
"""
import contextlib
import sys
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class _Local(threading.local):
    def __init__(self):
        self.stack = []     # the calling thread's open spans' records


_on = False
_OFF = contextlib.nullcontext()
_records = []
_steps = 0          # predict spans begun since the list was last cleared
_offset = 0         # realtime less monotonic, ns, taken by enable(True)
_local = _Local()
_looked = None      # (the running autograd profiler or None, CPU ops?)


class Record:
    """One span: ``name`` (without the ``r3det.`` prefix), ``begin_ns`` and
    ``end_ns`` on the profiler's host clock, ``step`` (None outside a
    ``predict`` span), ``parent`` (its index in the same list, None at the
    top) and ``h2d_bytes``."""
    __slots__ = ('name', 'begin_ns', 'end_ns', 'step', 'parent', 'h2d_bytes',
                 'index')

    def __init__(self, name, step, parent, index):
        self.name, self.step, self.parent = name, step, parent
        self.begin_ns = self.end_ns = None
        self.h2d_bytes = 0
        self.index = index

    def __repr__(self):
        return (f'Record({self.name!r}, {self.begin_ns}, {self.end_ns}, '
                f'step={self.step}, parent={self.parent}, '
                f'h2d_bytes={self.h2d_bytes})')


def enable(flag):
    """Switch the spans on (true), with an empty list, or off."""
    global _on, _offset, _steps
    if flag:
        _records.clear()
        _steps = 0
        _offset = time.time_ns() - time.monotonic_ns()
    _on = bool(flag)


def enabled():
    """Whether the spans are on."""
    return _on


def records():
    """The spans recorded since tracing turned on or this was last called,
    in the order they began; the list is cleared. Call it outside any
    span."""
    global _steps
    out = _records[:]
    _records.clear()
    _steps = 0
    return out


def count_h2d(*tensors):
    """Count the bytes of ``tensors``, just copied from the host to the
    device, in the innermost open span while tracing is on."""
    if _on and _local.stack:
        _local.stack[-1].h2d_bytes += sum(t.nbytes for t in tensors)


def span(name):
    """A context that records the span ``name`` while tracing is on, and
    the shared no-op context while it is off."""
    if _on:
        return _Span(name)
    return _OFF


class _Span:
    __slots__ = ('name', 'rec', 'range')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _steps
        stack = _local.stack
        top = stack[-1] if stack else None
        if self.name == 'predict':
            step = _steps
            _steps += 1
        else:
            step = None if top is None else top.step
        rec = self.rec = Record(self.name, step,
                                None if top is None else top.index,
                                len(_records))
        _records.append(rec)
        stack.append(rec)
        self.range = None
        if _cpu_ops_profiled():
            self.range = torch.profiler.record_function('r3det.' + rec.name)
            self.range.__enter__()
        rec.begin_ns = time.monotonic_ns() + _offset
        return rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.monotonic_ns() + _offset
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        return False


def _cpu_ops_profiled():
    """Whether a running profiler records CPU ops: the ``record_function``
    ranges exist only for such a profiler. The running profiler is looked
    for once a profiling run, in the frames of the calling thread; where
    none is found there, the spans take the ranges."""
    global _looked
    if not _autograd_profiler._is_profiler_enabled:
        _looked = None
        return False
    if _looked is None or (_looked[0] is not None
                           and _looked[0].kineto_results is not None):
        _looked = _running_profiler()
    return _looked[1]


def _running_profiler():
    cpu = torch.profiler.ProfilerActivity.CPU
    frame = sys._getframe(1)
    while frame is not None:
        for v in list(frame.f_locals.values()):
            if isinstance(v, torch.profiler.profile):
                v = v.profiler
            if (isinstance(v, _autograd_profiler.profile)
                    and getattr(v, 'entered', False)
                    and v.kineto_results is None):
                return v, cpu in v.kineto_activities
        frame = frame.f_back
    return None, True
