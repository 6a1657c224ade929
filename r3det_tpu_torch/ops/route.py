"""Whether a call runs a hand-written kernel or its plain PyTorch form.

One switch, on by default: ``with kernels(False):`` turns it off for a
block of code, as ``torch.no_grad()`` turns off autograd (``kernels(True)``
changes nothing). Each kernel's ops module has one contract that returns
None or why the kernel does not take these inputs: what it takes (dtype,
shapes), then :func:`refusal`. The op's public entry runs the kernel where
it holds, the plain form otherwise; its ``_cuda`` wrapper raises with the
reason (:func:`check`).
"""
import contextlib
import contextvars

import torch

_ON = contextvars.ContextVar('r3det_tpu_torch_kernels', default=True)


def kernels_on():
    return _ON.get()


@contextlib.contextmanager
def kernels(on=True):
    token = _ON.set(bool(on) and _ON.get())
    try:
        yield
    finally:
        _ON.reset(token)


def _needs_grad(tensors):
    return torch.is_grad_enabled() and any(
        getattr(t, 'requires_grad', False) for t in tensors)


def refusal(x, dtype, *needs, want=torch.bfloat16):
    """None, or why no kernel runs on ``x`` computing in ``dtype``: not
    ``want``, the switch off, ``x`` not on a card, or (no backward: the
    tensors it reads as ``needs``) a gradient to carry."""
    if dtype != want:
        return f'the kernel computes in {want}, not {dtype}'
    if not _ON.get():
        return 'the kernels are switched off'
    if not x.is_cuda:
        return f'the kernel takes CUDA tensors, not {x.device}'
    if _needs_grad(needs):
        return 'the kernel has no backward, and gradients are on'
    return None


def check(why, what):
    """Raise ``ValueError`` with a contract's reason ``why``, if any."""
    if why is not None:
        raise ValueError(f'{what}: {why}')


def forbid_grad(what, *tensors):
    """Raise ``RuntimeError`` if any of ``tensors`` needs a gradient: K4, K5
    and QConv's int8 conv have no backward (nor the JAX package's)."""
    if _needs_grad(tensors):
        raise RuntimeError(f'{what} has no backward: run it with gradients '
                           f'off (torch.no_grad) or on tensors that need none')
