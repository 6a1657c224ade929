"""The port's spans: ``torch.profiler`` ranges at the serving path's layer
boundaries, switched by one flag.

Off (the default), :func:`span` hands back one shared no-op context, so a
span site costs one flag check. On, each span is a
``torch.profiler.record_function`` range named ``r3det.<name>``: the
profiler stores the spans on the clock of the device kernels it traces,
nests them by containment on the calling thread and exports them with
``export_chrome_trace``. Outside a profiler a range records nothing
but still costs its entry and exit.

    from r3det_tpu_torch.utils import tracing
    tracing.enable(True)
    with torch.profiler.profile() as prof:
        step(images)
    tracing.enable(False)
    prof.export_chrome_trace('trace.json')
"""
import contextlib

import torch

_on = False
_OFF = contextlib.nullcontext()


def enable(flag):
    """Switch the spans on (true) or off."""
    global _on
    _on = bool(flag)


def enabled():
    """Whether the spans are on."""
    return _on


def span(name):
    """A context that records the range ``r3det.<name>`` while tracing is
    on, and the shared no-op context while it is off."""
    if _on:
        return torch.profiler.record_function('r3det.' + name)
    return _OFF
