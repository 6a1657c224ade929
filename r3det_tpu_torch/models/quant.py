"""Post-training int8 quantization for the serving path.

Port of ``r3det_tpu/models/quant.py``: ``QConv``, ``conv_factory`` and
``calibrate``, with the same scheme:

- weights: per-output-channel symmetric int8, quantized from the f32
  parameters (``weight``, ``bias``, those of :class:`.conv.Conv2d`, so one
  state dict serves both); the codes are kept until the weight changes
  (its version counter or storage), as the JAX package derives them once
  per trace;
- activations: per-tensor symmetric int8 with a calibrated scale, the
  buffer ``act_absmax`` (the flax ``quant_stats/.../act_absmax``); 0 means
  uncalibrated, and then a non-static ``QConv`` takes ``max|x|`` of its
  input on the device (``where(amax > 0, amax, max|x|)``, no host sync);
- no backward (the JAX package's int8 conv has none either): under
  autograd a ``QConv`` whose weight or input needs gradients raises;
- the product: int8 x int8 -> exact int32, then
  ``acc * (ascale * kscale) [+ bias]``. A bf16 model rounds the int32 sums
  to bf16 before that dequant, as the JAX package's bf16 conv output does;
  an f32 model keeps them exact. ``ops/int8_conv.py::qconv`` runs it: the
  int8 conv kernel on a card (``kernels`` on, bf16 output:
  ``QConv.kernel_route``), its plain form (im2col + ``torch._int_mm``)
  otherwise, an f32 model's on a card too.

A ``QConv`` may be handed a pre-quantized ``(int8 NHWC codes, ascale)``
pair (the int8 activation storage of ``Bottleneck.int8_act``); it then
needs the output ``dtype``. :meth:`QConv.fused` is the serving route of a
bf16 static model: one launch of the kernel that also applies the
FrozenBN, residual and ReLU that follow the conv and writes the next
static ``QConv``'s int8 codes (``ops/int8_conv.py::qconv_fused``).
"""
import functools

import torch
from torch import nn

from ..ops.grad_guard import forbid_grad
from ..ops.int8_conv import (pack_weights, qconv, qconv_fused,
                             qconv_fused_reference, qconv_reference,
                             quantize_weights)
from .conv import Conv2d


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def act_absmax(buf, x, calibrating, static):
    """The activation absmax a quantizer uses, as the JAX package takes it:
    the calibrated ``buf`` when static; otherwise ``max|x|`` unless ``buf``
    is set. While calibrating, ``buf`` first takes the running max."""
    if not calibrating and static:
        return buf
    dyn = x.float().abs().amax()
    if calibrating:
        buf.copy_(torch.maximum(buf, dyn))
    return torch.where(buf > 0, buf, dyn)


class QConv(nn.Module):
    """int8 symmetric-PTQ convolution with :class:`.conv.Conv2d`'s
    parameters. forward(x NCHW channels_last, or (codes NHWC int8, ascale))
    -> NCHW channels_last in ``x``'s dtype (or ``dtype``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, static_scale=False, kernels=True):
        super().__init__()
        self.kernels = kernels
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.static_scale = static_scale
        self.calibrating = False
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer('act_absmax', torch.zeros(()))
        self._codes = (None, None)
        self._act_scale = (None, None)

    def codes(self):
        """The weight's int8 codes, derived once per weight (and bias)
        version: ``(wi, kscale, bias, packed)`` with ``wi`` HWIO int8,
        ``kscale`` the (Co,) f32 scale (per output channel over kh, kw,
        ci), ``bias`` f32 or None, and ``packed`` the kernel's layout of
        ``wi`` (``pack_weights``) when the weight lies on a card, else
        None."""
        w, b = self.weight, self.bias
        key = (w.data_ptr(), w._version, w.device,
               None if b is None else (b.data_ptr(), b._version))
        if self._codes[0] != key:
            with torch.no_grad():
                wi, kscale = quantize_weights(w.permute(2, 3, 1, 0),
                                              axes=(0, 1, 2))
                wi = wi.contiguous()
                bias = None if b is None else b.detach().float().contiguous()
                packed = pack_weights(wi) if wi.is_cuda else None
            self._codes = (key, (wi, kscale.reshape(-1).contiguous(), bias,
                                 packed))
        return self._codes[1]

    def act_scale(self):
        """The calibrated per-tensor input scale, ``max(act_absmax, 1e-8) /
        127`` (f32 device scalar), as ``forward`` takes it when static;
        kept until ``act_absmax`` changes."""
        a = self.act_absmax
        key = (a.data_ptr(), a._version)
        if self._act_scale[0] != key:
            self._act_scale = (key, a.clamp_min(1e-8) / 127.0)
        return self._act_scale[1]

    def kernel_route(self, x, dtype):
        """Whether :meth:`forward` takes :func:`qconv` (the int8 conv
        kernel): a card, kernels on, bf16 output (the kernel writes bf16
        only; an f32 model takes the plain form)."""
        return self.kernels and x.is_cuda and dtype == torch.bfloat16

    def forward(self, x, dtype=None):
        forbid_grad('the int8 conv (QConv)', self.weight, self.bias,
                    x[0] if isinstance(x, tuple) else x)
        wi, kscale, bias, packed = self.codes()
        if isinstance(x, tuple):
            x, ascale = x                                    # int8 NHWC codes
        else:
            dtype = dtype or x.dtype
            x = x.permute(0, 2, 3, 1)                        # NHWC
            absmax = act_absmax(self.act_absmax, x, self.calibrating,
                                self.static_scale)
            ascale = absmax.clamp_min(1e-8) / 127.0
        if self.kernel_route(x, dtype):
            y = qconv(x, ascale, wi, kscale, bias, self.stride, self.padding,
                      dtype, packed=packed)
        else:
            y = qconv_reference(x, ascale, wi, kscale, bias, self.stride,
                                self.padding, dtype)
        return y.permute(0, 3, 1, 2)

    def fused(self, x, *, affine=None, residual=None, relu=False,
              out_scale=None):
        """The static bf16 serving route: ``x`` NHWC bf16 (quantized at
        :meth:`act_scale`) or ``(int8 NHWC codes, ascale)``; then the
        epilogue of ``qconv_fused`` (FrozenBN ``affine``, ``residual``,
        ``relu``, int8 codes at ``out_scale``). Returns NHWC bf16, or
        ``(codes, out_scale)``; one kernel launch on a card (``kernels``
        on), the plain composition otherwise. Neither has a backward."""
        forbid_grad('the int8 conv (QConv)', self.weight, self.bias,
                    x[0] if isinstance(x, tuple) else x)
        wi, kscale, bias, packed = self.codes()
        x, ascale = x if isinstance(x, tuple) else (x, self.act_scale())
        kw = dict(affine=affine, residual=residual, relu=relu,
                  out_scale=out_scale)
        if self.kernels:
            return qconv_fused(x, ascale, wi, kscale, bias, self.stride,
                               self.padding, packed=packed, **kw)
        return qconv_fused_reference(x, ascale, wi, kscale, bias,
                                     self.stride, self.padding, **kw)


def conv_factory(quantize):
    """:class:`.conv.Conv2d` when ``quantize`` is false, else ``QConv``:
    ``True`` (dynamic scale while uncalibrated) or ``'static'`` (trusts the
    calibrated ``act_absmax``, the serving configuration)."""
    if not quantize:
        return Conv2d
    return functools.partial(QConv, static_scale=quantize == 'static')


@torch.no_grad()
def calibrate(model, sample_batches):
    """One-pass activation-range calibration: runs ``model`` over
    ``sample_batches`` with every quantizer recording the running max of
    ``max|x|`` over all of its calls (a head-tower ``QConv`` runs on every
    pyramid level, so one scale covers them all). Returns ``model``."""
    mods = [m for m in model.modules() if hasattr(m, 'calibrating')]
    for m in mods:
        m.calibrating = True
    try:
        for x in sample_batches:
            model(x)
    finally:
        for m in mods:
            m.calibrating = False
    return model
