"""The bf16 conv epilogue of a bottleneck conv: plain PyTorch form and the
CUDA kernel (``csrc/conv_epilogue.cu``).

What follows a conv in ``models/resnet.py::Bottleneck``'s unfused route, in
one pass over the conv output ``a``: its FrozenBN affine ``(inv, b)``
(``FrozenBN.affine(torch.bfloat16)``), optionally the block's residual,
either ``r`` as it is (identity) or a raw downsample-conv output ``d``
with its own affine ``(d, inv_d, b_d)``, then optionally ReLU. Each op
rounds to bf16 as the unfused route's bf16 ops do:

    y = bf16(a * inv);  y = bf16(y + b)
    r' = r  |  bf16(bf16(d * inv_d) + b_d)
    y = bf16(y + r')                       (residual)
    y = relu(y)                            (relu; F.relu's NaN and zeros)

so the kernel is bit-equal to that route on the same conv outputs. BN is
not folded into the weights (that computes another bf16 function).

Tensors are NCHW views of ``torch.channels_last`` memory (NHWC bytes), as
the trunk keeps its activations; ``inv`` and ``b`` are (C,). The JAX
package has no such kernel: XLA fuses these ops into its convolution.
"""
import torch
import torch.nn.functional as F

from .. import _ext
from . import route

CHANNEL_MULTIPLE = 64           # every ResNet-50 width is a multiple


def _affine(x, inv, b):
    shape = (1, -1, 1, 1)
    y = (x.float() * inv.float().view(shape)).to(torch.bfloat16)
    return (y.float() + b.float().view(shape)).to(torch.bfloat16)


def conv_epilogue_reference(a, inv, b, residual=None, relu=True):
    """The plain form, in the kernel's roundings: ``residual`` is None, a
    tensor (added as it is) or ``(d, inv_d, b_d)`` (``d`` through its own
    affine first). bf16 in and out."""
    y = _affine(a, inv, b)
    if residual is not None:
        r = _affine(*residual) if isinstance(residual, tuple) else residual
        y = (y.float() + r.float()).to(torch.bfloat16)
    return F.relu(y) if relu else y


def refusal(a, *needs):
    """The kernel's contract (``ops/route.py``): bf16 ``a``, C % 64 == 0."""
    if a.shape[1] % CHANNEL_MULTIPLE:
        return f'the kernel takes C % 64 == 0, not {a.shape[1]}'
    return route.refusal(a, a.dtype, a, *needs)


def _check(t, shape, what):
    if not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
            or not t.is_contiguous(memory_format=torch.channels_last) \
            or t.data_ptr() % 16:
        raise ValueError(f'{what} must be a 16-byte aligned channels_last '
                         f'bfloat16 CUDA tensor of shape {shape}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}')


def _check_vec(t, c, device, what):
    if t.device != device or t.dtype != torch.bfloat16 \
            or tuple(t.shape) != (c,) or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f'{what} must be a contiguous ({c},) bfloat16 '
                         f'tensor on {device}')


def conv_epilogue_cuda(a, inv, b, residual=None, relu=True):
    """Launch the kernel; it writes the result into ``a``'s memory and
    returns ``a``. (B, C, H, W) channels_last bf16 on a card, C a multiple
    of 64; ``residual`` as in :func:`conv_epilogue_reference`."""
    shape = tuple(a.shape)
    if len(shape) != 4:
        raise ValueError(f'the conv epilogue takes (B, C, H, W), got {shape}')
    route.check(refusal(a), 'conv_epilogue')
    _check(a, shape, 'a')
    c = shape[1]
    kind = 0 if residual is None else 2 if isinstance(residual, tuple) else 1
    r, inv_d, b_d = residual if kind == 2 else (residual, None, None)
    vecs = [(inv, 'inv'), (b, 'b')]
    if kind:
        _check(r, shape, 'the residual')
    if kind == 2:
        vecs += [(inv_d, 'inv_d'), (b_d, 'b_d')]
    for t, what in vecs:
        _check_vec(t, c, a.device, what)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _ext.launch('conv_epilogue', a.data_ptr(), inv.data_ptr(), b.data_ptr(),
                ptr(r), ptr(inv_d), ptr(b_d), a.data_ptr(), a.numel() // c,
                c, kind, int(relu), _ext.sm_count(a.device),
                _ext.current_stream(a.device))
    return a


def conv_epilogue(a, inv, b, residual=None, relu=True):
    """The epilogue: the kernel where :func:`refusal` holds (in place in
    ``a``), the plain form otherwise."""
    rest = residual if isinstance(residual, tuple) else (residual,)
    if refusal(a, inv, b, *rest) is None:
        return conv_epilogue_cuda(a, inv, b, residual, relu)
    return conv_epilogue_reference(a, inv, b, residual, relu)
