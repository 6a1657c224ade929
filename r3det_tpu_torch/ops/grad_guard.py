"""The guard of the routes that have no backward.

K4 (the stem pool), K5 and K5 q8 (the fused bottleneck) and QConv's int8
conv have no backward, neither in the JAX package (its Pallas calls cannot
be differentiated) nor in the port. Their routes call :func:`forbid_grad`
first: under autograd, with a tensor that requires gradients, they raise
rather than return a result that silently carries none.
"""
import torch


def forbid_grad(what, *tensors):
    """Raise ``RuntimeError`` when gradients are on and any of ``tensors``
    requires them."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f'{what} has no backward: run it with gradients '
                           f'off (torch.no_grad) or on tensors that need none')
