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
- the product: int8 x int8 -> exact int32, then
  ``acc * (ascale * kscale) [+ bias]``. A bf16 model rounds the int32 sums
  to bf16 before that dequant, as the JAX package's bf16 conv output does;
  an f32 model keeps them exact. ``ops/int8_conv.py::qconv`` runs it: the
  int8 conv kernel on a card (``kernels`` on, bf16), its plain form
  (im2col + ``torch._int_mm``) otherwise.

A ``QConv`` may be handed a pre-quantized ``(int8 NHWC codes, ascale)``
pair (the int8 activation storage of ``Bottleneck.int8_act``); it then
needs the output ``dtype``.
"""
import functools

import torch
from torch import nn

from ..ops.int8_conv import qconv, qconv_reference, quantize_weights
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

    def codes(self):
        """HWIO int8 codes and (Co,) scale of the weight (per output
        channel over kh, kw, ci)."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._codes[0] != key:
            with torch.no_grad():
                wi, kscale = quantize_weights(w.permute(2, 3, 1, 0),
                                              axes=(0, 1, 2))
            self._codes = (key, (wi.contiguous(), kscale.reshape(-1)))
        return self._codes[1]

    def forward(self, x, dtype=None):
        wi, kscale = self.codes()
        if isinstance(x, tuple):
            x, ascale = x                                    # int8 NHWC codes
        else:
            dtype = dtype or x.dtype
            x = x.permute(0, 2, 3, 1)                        # NHWC
            absmax = act_absmax(self.act_absmax, x, self.calibrating,
                                self.static_scale)
            ascale = absmax.clamp_min(1e-8) / 127.0
        fn = qconv if self.kernels else qconv_reference
        y = fn(x, ascale, wi, kscale, self.bias, self.stride, self.padding,
               dtype)
        return y.permute(0, 3, 1, 2)


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
