"""LSKNet backbone (Li et al., "Large Selective Kernel Network for Remote
Sensing Object Detection", ICCV 2023, arXiv:2303.09030), as
``mmrotate/models/backbones/lsknet.py`` of github.com/zcablii/LSKNet
builds it (``LSKNet``, ``OverlapPatchEmbed``, ``Block``, ``Attention``,
``LSKblock``, ``Mlp``, ``DWConv``).

The JAX package has no LSKNet; this module has no counterpart there.
Module, parameter and buffer names are the source's
(``patch_embed1.proj.weight``, ``block2.0.attn.spatial_gating_unit.
conv_spatial.weight``, ``block3.1.mlp.dwconv.dwconv.bias``,
``block1.0.layer_scale_1``, ``norm4.weight``), so one state dict serves
this module and the benchmark's plain reference. Drop-path and dropout
are left out: they are inert at inference, and training an LSKNet is not
provided.

- Stage i's ``patch_embed{i}``: a 7x7/s4 conv (pad 3) on the image for the
  first stage, a 3x3/s2 conv (pad 1) on the previous stage's output after,
  then BN.
- Each block ``block{i}.{j}``: ``x + layer_scale_1 * Attn(norm1(x))``, then
  ``x + layer_scale_2 * MLP(norm2(x))``. ``Attn(u)`` is ``proj_2(LSK(
  GELU(proj_1(u)))) + u``: the shortcut is the normed ``u``. ``LSK(v)``
  (``attn.spatial_gating_unit``): ``a1`` a depthwise 5x5 conv of ``v``,
  ``a2`` a depthwise 7x7 conv of dilation 3 of ``a1``, each squeezed to
  C/2 channels by a 1x1 conv (``b1``, ``b2``); the mean and the max over
  the C channels of both, a dense 7x7 conv of 2 -> 2 channels
  (``conv_squeeze``) and a sigmoid give the weights ``s``; ``v`` times
  the 1x1 conv back to C of ``b1 * s0 + b2 * s1``. ``MLP(u)`` is
  ``fc2(GELU(dwconv(fc1(u))))`` with a depthwise 3x3 ``dwconv``.
- Each stage leaves through ``norm{i}``, a LayerNorm over the channels at
  each position (eps 1e-6); its output is the stage's and the next
  stage's input.

Every conv has a bias, GELU is exact and BN (SyncBN in the source)
computes with its running statistics (eps 1e-5): its scale and shift are
folded once per dtype and weight version (``BatchNorm.affine``).

The input is the NHWC image; the outputs are every stage's NCHW map
(channels_last memory) with ``out_channels`` channels; the FPN takes the
last three. Parameters stay float32 and every layer computes in
``dtype``: the convs through cuDNN on channels_last (grouped for the
undilated taps) but the dilated taps, which take PyTorch's depthwise
kernel on contiguous NCHW; GELU and LayerNorm with float32 statistics
(PyTorch's kernels do for bf16). The selection's channel mean is summed
in float32, and its 2-channel map, ``conv_squeeze`` and the sigmoid stay
in float32; the weights go back to ``dtype`` for the products. The
forward makes no host-to-device copy and reads nothing back.

Where its contract holds (``ops/lsk_attn.py::refusal``: bf16
channels_last on a card, C % 16 == 0, the kernels switched on, no
gradient to carry), a block's attention sub-block runs on the route of
``ops/lsk_attn.py::attention`` instead of the modules above: four
products on the NHWC view around five CUDA passes (``csrc/lsk_attn.cu``),
from a pack of its weights (``Block.attn_pack``: norm1 folded into
proj_1, conv1 and conv2 as one block-diagonal product), kept until a
parameter or buffer changes. Where its contract holds
(``ops/lsk_mlp.py::refusal``: the same, with C and the hidden width in
16-byte vectors), the MLP sub-block runs ``ops/lsk_mlp.py::mlp``: fc1's
and fc2's products on the NHWC view (norm2 folded into fc1) around two
CUDA passes, fc1's bias, ``dwconv``, its bias and GELU in one
(``lsk_dw_gelu``), fc2's bias and the layer-scaled residual in the other
(``lsk_bias_scale``), from ``Block.mlp_pack``, kept alike. Everything
else, and both sub-blocks in float32, on the CPU or under autograd, is the
eager code above.

Spans (``utils/tracing.py``): ``backbone.lsk.embed`` (each stage's patch
embedding), ``backbone.lsk.attn`` (each block, from ``norm1`` through the
residual add), ``backbone.lsk.mlp`` (each block, ``norm2`` through its
residual add) and ``backbone.lsk.norm`` (each stage's LayerNorm).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lsk_attn, lsk_mlp
from ..utils.tracing import span
from .conv import Conv2d
from .swin import LayerNorm


def _channel(t):
    return t.view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    """Inference BN under ``nn.BatchNorm2d``'s names: ``x * inv + b`` with
    ``inv`` and ``b`` folded in float32 from the running statistics."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))
        self._affine_cache = (None, None)

    def affine(self, dtype):
        """``(inv, b)``, (C,) each, in ``dtype``; without autograd kept
        until a parameter or buffer changes."""
        if torch.is_grad_enabled():
            return self._affine(dtype)
        key = (dtype, *((t.data_ptr(), t._version) for t in
                        (self.weight, self.bias, self.running_mean,
                         self.running_var)))
        if self._affine_cache[0] != key:
            self._affine_cache = (key, self._affine(dtype))
        return self._affine_cache[1]

    def _affine(self, dtype):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv.to(dtype), (self.bias - self.running_mean * inv).to(dtype)

    def forward(self, x):
        inv, b = self.affine(x.dtype)
        return torch.addcmul(_channel(b), x, _channel(inv))


class LSKblock(nn.Module):
    """The large selective kernel: two receptive fields, weighted a
    position by a spatial selection of their channel mean and max."""

    def __init__(self, dim):
        super().__init__()
        self.conv0 = Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv_spatial = Conv2d(dim, dim, 7, padding=9, groups=dim,
                                   dilation=3)
        self.conv1 = Conv2d(dim, dim // 2, 1)
        self.conv2 = Conv2d(dim, dim // 2, 1)
        self.conv_squeeze = Conv2d(2, 2, 7, padding=3)
        self.conv = Conv2d(dim // 2, dim, 1)

    def select(self, b1, b2):
        """(B, 2, H, W) float32: the sigmoid of ``conv_squeeze`` on the
        mean and the max over the channels of ``b1`` and ``b2``."""
        c = b1.shape[1] + b2.shape[1]
        total = b1.sum(1, keepdim=True, dtype=torch.float32) \
            + b2.sum(1, keepdim=True, dtype=torch.float32)
        top = torch.maximum(b1.amax(1, keepdim=True),
                            b2.amax(1, keepdim=True))
        agg = torch.cat([total / c, top.float()], 1)
        return torch.sigmoid(self.conv_squeeze(agg))

    def spatial(self, a1):
        """``conv_spatial`` on contiguous NCHW, back to channels_last:
        cuDNN runs a dilated depthwise conv on channels_last through a
        direct kernel 4.7x slower than PyTorch's own depthwise kernel with
        both layout copies (7.18 against 1.54 ms at stage 1, batch 8 of
        1024^2, H100); the undilated taps are faster on channels_last.
        The weight is copied to NCHW strides too: a (C, 1, k, k) weight
        moved to channels_last counts as contiguous, and PyTorch would
        take cuDNN's channels_last path for its strides."""
        conv = self.conv_spatial
        w = conv.weight.to(a1.dtype, memory_format=torch.contiguous_format,
                           copy=True)
        y = conv._conv_forward(a1.contiguous(), w, conv.bias.to(a1.dtype))
        return y.contiguous(memory_format=torch.channels_last)

    def forward(self, v):
        a1 = self.conv0(v)
        a2 = self.spatial(a1)
        b1, b2 = self.conv1(a1), self.conv2(a2)
        s = self.select(b1, b2).to(v.dtype)
        m = torch.addcmul(b1 * s[:, :1], b2, s[:, 1:])
        return v * self.conv(m)


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1)
        self.spatial_gating_unit = LSKblock(dim)
        self.proj_2 = Conv2d(dim, dim, 1)

    def forward(self, u):
        y = self.spatial_gating_unit(F.gelu(self.proj_1(u)))
        return self.proj_2(y) + u


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1)
        self.dwconv = DWConv(hidden)
        self.fc2 = Conv2d(hidden, dim, 1)

    def forward(self, u):
        return self.fc2(F.gelu(self.dwconv(self.fc1(u))))


class Block(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = BatchNorm(dim)
        self.attn = Attention(dim)
        self.norm2 = BatchNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.ones(dim))
        self.layer_scale_2 = nn.Parameter(torch.ones(dim))
        self._packs = {}

    def attn_params(self):
        """The attention sub-block's parameters and norm1's buffers."""
        return (*self.norm1.parameters(), *self.norm1.buffers(),
                *self.attn.parameters(), self.layer_scale_1)

    def mlp_params(self):
        """The MLP sub-block's parameters and norm2's buffers."""
        return (*self.norm2.parameters(), *self.norm2.buffers(),
                *self.mlp.parameters(), self.layer_scale_2)

    def _kept(self, name, dtype, params, build):
        """``build(dtype)``; without autograd kept under ``name`` until a
        tensor of ``params`` changes."""
        if torch.is_grad_enabled():
            return build(dtype)
        key = (dtype, *((t.data_ptr(), t._version) for t in params))
        kept = self._packs.get(name)
        if kept is None or kept[0] != key:
            kept = self._packs[name] = (key, build(dtype))
        return kept[1]

    def attn_pack(self, dtype):
        """``ops/lsk_attn.py::pack`` of this block's attention in ``dtype``;
        without autograd kept until a parameter or buffer changes."""
        return self._kept('attn', dtype, self.attn_params(), self._attn_pack)

    def mlp_pack(self, dtype):
        """``ops/lsk_mlp.py::pack`` of this block's MLP in ``dtype``;
        without autograd kept until a parameter or buffer changes."""
        return self._kept('mlp', dtype, self.mlp_params(), self._mlp_pack)

    def _attn_pack(self, dtype):
        sgu = self.attn.spatial_gating_unit
        convs = (self.attn.proj_1, sgu.conv0, sgu.conv_spatial, sgu.conv1,
                 sgu.conv2, sgu.conv_squeeze, sgu.conv, self.attn.proj_2)
        return lsk_attn.pack(dtype, self.norm1.affine(torch.float32),
                             *((m.weight, m.bias) for m in convs),
                             self.layer_scale_1)

    def _mlp_pack(self, dtype):
        convs = (self.mlp.fc1, self.mlp.dwconv.dwconv, self.mlp.fc2)
        return lsk_mlp.pack(dtype, self.norm2.affine(torch.float32),
                            *((m.weight, m.bias) for m in convs),
                            self.layer_scale_2)

    def forward(self, x):
        with span('backbone.lsk.attn'):
            if lsk_attn.refusal(x, *self.attn_params()) is None:
                x = lsk_attn.attention(x, self.attn_pack(x.dtype))
            else:
                x = torch.addcmul(x, _channel(self.layer_scale_1.to(x.dtype)),
                                  self.attn(self.norm1(x)))
        with span('backbone.lsk.mlp'):
            if lsk_mlp.refusal(x, self.mlp.fc1.out_channels,
                               *self.mlp_params()) is None:
                return lsk_mlp.mlp(x, self.mlp_pack(x.dtype))
            return torch.addcmul(x, _channel(self.layer_scale_2.to(x.dtype)),
                                 self.mlp(self.norm2(x)))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch, stride):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, stride=stride,
                           padding=patch // 2)
        self.norm = BatchNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class LSKNet(nn.Module):
    """NHWC image (B, H, W, 3) -> every stage's map, NCHW channels_last,
    in ``dtype``."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(2, 2, 4, 2),
                 mlp_ratios=(8, 8, 4, 4), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_stages = len(depths)
        cin = 3
        for i, (dim, depth, ratio) in enumerate(zip(embed_dims, depths,
                                                    mlp_ratios)):
            setattr(self, f'patch_embed{i + 1}', OverlapPatchEmbed(
                cin, dim, 7 if i == 0 else 3, 4 if i == 0 else 2))
            setattr(self, f'block{i + 1}', nn.ModuleList(
                Block(dim, ratio) for _ in range(depth)))
            setattr(self, f'norm{i + 1}', LayerNorm(dim, eps=1e-6))
            cin = dim
        self.out_channels = tuple(embed_dims)

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        outs = []
        for i in range(1, self.num_stages + 1):
            with span('backbone.lsk.embed'):
                x = getattr(self, f'patch_embed{i}')(x)
            for block in getattr(self, f'block{i}'):
                x = block(x)
            with span('backbone.lsk.norm'):
                x = getattr(self, f'norm{i}')(x.permute(0, 2, 3, 1)) \
                    .permute(0, 3, 1, 2)
            outs.append(x)
        return tuple(outs)
