"""ResNet backbone (C2..C5), inference only.

Port of ``r3det_tpu/models/resnet.py`` (``FrozenBN``, ``Bottleneck``,
``space_to_depth_2x``, ``ResNet`` with the folded space-to-depth stem).
Depths 10, 14 and 50. Activations are NCHW tensors in
``torch.channels_last`` memory, i.e. NHWC bytes; the public input is the
NHWC image. Parameters stay f32 and every layer computes in its input's
dtype (``dtype`` for the whole trunk), as the flax modules do.

The stem keeps the JAX package's folded ``(4, 4, 12, 64)`` HWIO kernel
(``conv1.kernel``) and runs through :mod:`..ops.stem_pool`:
``stem_fused_kernel`` (the port's default) takes the fused stem, K3 in a
bf16 model on a card (on weights packed once, ``ResNet.stem_pack``); off,
the conv and the pool run apart, and ``stem_pool_kernel`` takes K4 for the
pool. ``quantize`` makes the stem and every bottleneck conv
int8 (``models/quant.py``); ``fused_blocks`` sends stride-1 identity
blocks through :mod:`..ops.bottleneck_fuse` (K5); ``int8_act`` stores each
block input as int8 (serving, with ``quantize='static'``). A bf16
``quantize='static'`` block on a card runs each conv as one launch of the
int8 conv kernel with its FrozenBN, ReLU, residual and the next conv's
quantize fused (``Bottleneck.q8_fused_forward``). ``kernels`` off takes
every plain version.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bottleneck_fuse import (fold_bn, fused_bottleneck_packed,
                                   fused_bottleneck_q8_reference,
                                   fused_bottleneck_reference,
                                   pack_bottleneck)
from ..ops.int8_conv import quantize_act
from ..ops.stem_pool import (pack_stem, stem_conv_pool_cuda,
                             stem_conv_pool_q8_reference,
                             stem_conv_pool_reference, stem_conv_pool_unfused)
from .quant import act_absmax, conv_factory

STAGE_BLOCKS = {10: (1, 1, 1, 1), 14: (2, 1, 1, 1), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
WIDTHS = (64, 128, 256, 512)


class FrozenBN(nn.Module):
    """Affine-only BatchNorm: y = x * inv + b with inv and b computed in f32
    from the (frozen) statistics, then cast to the input's dtype."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self._affine_cache = (None, None)

    def affine(self, dtype):
        """``(inv, b)``, (C,) each, computed in f32 and cast to ``dtype``;
        without autograd, kept until a parameter or buffer changes (the
        fused int8 route reads it on every call)."""
        if torch.is_grad_enabled():
            return self._affine(dtype)
        key = (dtype, *((t.data_ptr(), t._version) for t in
                        (self.scale, self.bias, self.mean, self.var)))
        if self._affine_cache[0] != key:
            self._affine_cache = (key, self._affine(dtype))
        return self._affine_cache[1]

    def _affine(self, dtype):
        r = torch.rsqrt(self.var + self.eps)
        inv = (self.scale * r).to(dtype)
        return inv, (self.bias - self.mean * self.scale * r).to(dtype)

    def forward(self, x):
        inv, b = self.affine(x.dtype)
        return x * inv.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck ('pytorch' style), out = 4F.

    ``quantize`` (False | True | 'static') makes the convs ``QConv``s.
    ``int8_act`` (with 'static') quantizes the block input once with the
    calibrated ``in_absmax`` and shares the int8 codes between conv1, the
    downsample conv and the residual. ``fused`` sends the block through
    the fused bottleneck when it can (stride 1, identity residual,
    H % 8 == 0, F <= 256): int8 with 'static', bf16 otherwise; the fused
    block computes in bf16 and casts back to the input's dtype.
    """

    def __init__(self, inplanes, features, stride=1, quantize=False,
                 int8_act=False, fused=False, kernels=True):
        super().__init__()
        conv = conv_factory(quantize)
        self.features = features
        self.stride = stride
        self.quantize = quantize
        self.fused = fused
        self.kernels = kernels
        self.conv1 = conv(inplanes, features, 1, bias=False)
        self.bn1 = FrozenBN(features)
        self.conv2 = conv(features, features, 3, stride=stride, padding=1,
                          bias=False)
        self.bn2 = FrozenBN(features)
        self.conv3 = conv(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBN(features * 4)
        self.has_downsample = inplanes != features * 4 or stride != 1
        if self.has_downsample:
            self.downsample_conv = conv(inplanes, features * 4, 1,
                                        stride=stride, bias=False)
            self.downsample_bn = FrozenBN(features * 4)
        self.int8_act = int8_act and quantize == 'static'
        self._fused_pack = (None, None)
        if self.int8_act:
            self.calibrating = False
            self.register_buffer('in_absmax', torch.zeros(()))

    def q8_fused_route(self, x):
        """Whether this call takes :meth:`q8_fused_forward`: a bf16
        ``quantize='static'`` block on a card, kernels on, not
        calibrating."""
        return (self.quantize == 'static' and self.kernels and x.is_cuda
                and x.dtype == torch.bfloat16 and not self.conv1.calibrating)

    def q8_fused_forward(self, x):
        """The static int8 block with every FrozenBN, ReLU, residual and
        inter-conv quantize in the epilogue of its conv (``QConv.fused``):
        conv1 and conv2 write the next conv's int8 codes, the downsample
        its bf16 BN output, conv3 adds the residual (the block's int8 codes
        dequantized, under ``int8_act``) and applies the ReLU. The same
        ops, in the same order, as :meth:`forward`'s unfused route."""
        src = residual = self._block_codes(x) if self.int8_act else \
            x.permute(0, 2, 3, 1)                            # NHWC
        bf16 = torch.bfloat16
        y = self.conv1.fused(src, affine=self.bn1.affine(bf16), relu=True,
                             out_scale=self.conv2.act_scale())
        y = self.conv2.fused(y, affine=self.bn2.affine(bf16), relu=True,
                             out_scale=self.conv3.act_scale())
        if self.has_downsample:
            residual = self.downsample_conv.fused(
                src, affine=self.downsample_bn.affine(bf16))
        y = self.conv3.fused(y, affine=self.bn3.affine(bf16),
                             residual=residual, relu=True)
        return y.permute(0, 3, 1, 2)

    def _block_codes(self, x):
        """``int8_act``: the block input's NHWC int8 codes and scale (the
        running range while calibrating, the calibrated one after)."""
        x32 = x.float().permute(0, 2, 3, 1)
        absmax = act_absmax(self.in_absmax, x32, self.calibrating, True)
        ascale = absmax.clamp_min(1e-8) / 127.0
        return quantize_act(x32, ascale), ascale

    def can_fuse(self, x):
        return (self.fused and self.stride == 1 and not self.has_downsample
                and x.shape[2] % 8 == 0 and self.features <= 256)

    def _fused_q8(self):
        return self.quantize == 'static'

    def fused_pack_key(self):
        """What the fused kernel's pack depends on: the ``(data_ptr,
        _version)`` of the conv weights, the FrozenBN parameters and
        buffers and (int8) the calibrated ``act_absmax`` of each conv."""
        convs = (self.conv1, self.conv2, self.conv3)
        ts = [c.weight for c in convs]
        for bn in (self.bn1, self.bn2, self.bn3):
            ts += [bn.scale, bn.bias, bn.mean, bn.var]
        if self._fused_q8():
            ts += [c.act_absmax for c in convs]
        return (self._fused_q8(), self.conv1.weight.device,
                *((t.data_ptr(), t._version) for t in ts))

    def fused_pack(self):
        """The K5 kernel's operands (``pack_bottleneck``: BN-folded weights
        laid out as the kernel reads them, the biases and, int8, the codes
        and scales), made once per :meth:`fused_pack_key`, as
        ``ResNet.stem_pack`` keeps the stem's."""
        key = self.fused_pack_key()
        if self._fused_pack[0] != key:
            with torch.no_grad():
                amax = [c.act_absmax for c in
                        (self.conv1, self.conv2, self.conv3)] \
                    if self._fused_q8() else []
                pack = pack_bottleneck(*self._folded_weights(), *amax)
            self._fused_pack = (key, pack)
        return self._fused_pack[1]

    def _folded(self, conv, bn):
        """BN-folded HWIO kernel and bias (f32)."""
        return fold_bn(conv.weight.permute(2, 3, 1, 0), bn.scale, bn.bias,
                       bn.mean, bn.var)

    def _folded_weights(self):
        return [*self._folded(self.conv1, self.bn1),
                *self._folded(self.conv2, self.bn2),
                *self._folded(self.conv3, self.bn3)]

    def _fused_forward(self, x):
        """The fused block: K5 (bf16, or int8 with 'static') on the cached
        pack on a card with kernels on, its plain form otherwise."""
        xs = x.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
        if self.kernels and xs.is_cuda:
            y = fused_bottleneck_packed(xs, self.fused_pack())
        elif self._fused_q8():
            y = fused_bottleneck_q8_reference(
                xs, *self._folded_weights(), self.conv1.act_absmax,
                self.conv2.act_absmax, self.conv3.act_absmax)
        else:
            y = fused_bottleneck_reference(xs, *self._folded_weights())
        return y.to(x.dtype).permute(0, 3, 1, 2)

    def forward(self, x):
        if self.can_fuse(x):
            return self._fused_forward(x)
        if self.q8_fused_route(x):
            return self.q8_fused_forward(x)
        x_in, residual = x, x
        if self.int8_act:
            x_in = xi, ascale = self._block_codes(x)
            residual = (xi.float() * ascale).to(x.dtype).permute(0, 3, 1, 2)

        def conv(m, v):
            return m(v, x.dtype) if isinstance(v, tuple) else m(v)

        y = F.relu(self.bn1(conv(self.conv1, x_in)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            residual = self.downsample_bn(conv(self.downsample_conv, x_in))
        return F.relu(y + residual)


def space_to_depth_2x(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), packing 2x2 blocks in (dy, dx, c)
    channel order (the stem kernel's fold depends on it)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class _StemConv(nn.Module):
    """Holds the folded stem kernel under the flax name ``conv1/kernel``."""

    def __init__(self):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(4, 4, 12, 64))


class ResNet(nn.Module):
    """ResNet trunk: NHWC image (B, H, W, 3) -> (C2, C3, C4, C5), NCHW
    channels_last, in ``dtype``."""

    def __init__(self, depth=50, dtype=torch.float32, kernels=True,
                 stem_fused_kernel=True, stem_pool_kernel=False,
                 quantize=False, fused_blocks=False, int8_act=False):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.kernels = kernels
        self.stem_fused_kernel = stem_fused_kernel
        self.stem_pool_kernel = stem_pool_kernel
        self.quantize = quantize
        self.conv1 = _StemConv()
        self.bn1 = FrozenBN(64)
        self._stem_pack = (None, None)
        inplanes = 64
        for stage, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            for blk in range(num_blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                self.add_module(f'layer{stage + 1}_{blk}', Bottleneck(
                    inplanes, WIDTHS[stage], stride, quantize=quantize,
                    int8_act=int8_act, fused=fused_blocks, kernels=kernels))
                inplanes = WIDTHS[stage] * 4

    def stem_affine(self):
        """Folded FrozenBN of the stem (f32): ``(inv, off)``."""
        inv = self.bn1.scale * torch.rsqrt(self.bn1.var + 1e-5)
        return inv, self.bn1.bias - self.bn1.mean * inv

    def stem_kernel_route(self, x12):
        """Whether the fused stem takes its kernel (K3): a bf16 model on a
        card, kernels on (the kernel computes in bf16 only; an f32 model
        takes the plain form)."""
        return (self.kernels and x12.is_cuda
                and self.dtype == torch.bfloat16)

    def stem_pack(self):
        """The K3 kernel's operands (``pack_stem``: packed weights, folded
        affine), made once per version of the stem kernel and FrozenBN, as
        ``QConv.codes`` keeps its codes."""
        ts = (self.conv1.kernel, self.bn1.scale, self.bn1.bias,
              self.bn1.mean, self.bn1.var)
        key = (bool(self.quantize), self.conv1.kernel.device,
               *((t.data_ptr(), t._version) for t in ts))
        if self._stem_pack[0] != key:
            with torch.no_grad():
                pack = pack_stem(self.conv1.kernel, *self.stem_affine(),
                                 quantize=bool(self.quantize))
            self._stem_pack = (key, pack)
        return self._stem_pack[1]

    def stem(self, x12):
        if self.stem_fused_kernel and self.stem_kernel_route(x12):
            return stem_conv_pool_cuda(x12.contiguous(), self.stem_pack())
        inv, off = self.stem_affine()
        args = (x12, self.conv1.kernel, inv, off, self.dtype)
        q = bool(self.quantize)
        if not self.stem_fused_kernel:
            return stem_conv_pool_unfused(
                *args, quantize=q,
                pool_kernel=self.stem_pool_kernel and self.kernels)
        ref = stem_conv_pool_q8_reference if q else stem_conv_pool_reference
        return ref(*args)

    def forward(self, images):
        x = self.stem(space_to_depth_2x(images.to(self.dtype)))
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # NCHW, channels_last
        outs = []
        for stage, num_blocks in enumerate(STAGE_BLOCKS[self.depth]):
            for blk in range(num_blocks):
                x = getattr(self, f'layer{stage + 1}_{blk}')(x)
            outs.append(x)
        return tuple(outs)
