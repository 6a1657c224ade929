"""Fused ResNet stem: the plain PyTorch form and the CUDA kernel (K3).

The stem runs the folded 7x7/s2 conv as a 4x4/s1 conv over the
space-to-depth(2) image (``models/resnet.py::space_to_depth_2x``), then
the folded FrozenBN affine, ReLU, and the 3x3/s2 max-pool with -inf
padding. Port of ``r3det_tpu/ops/stem_pool.py::stem_conv_pool_reference``
(the function) and of the TPU kernel ``stem_conv_pool_s2d4_pallas`` (bf16
variant), whose CUDA counterpart is ``csrc/stem_pool.cu``.

Layouts follow the JAX package: ``x12`` (B, H, W, 12) NHWC, ``kernel``
(4, 4, 12, 64) HWIO, ``scale``/``bias`` (64,) f32, result (B, H/2, W/2, 64)
NHWC.
"""
import torch
import torch.nn.functional as F

from .. import _ext

CIN = 12
COUT = 64


def stem_conv_pool_reference(x12, kernel, scale, bias, dtype=torch.bfloat16):
    """conv (f32 accumulation of ``dtype`` operands) + affine + ReLU,
    rounded to ``dtype``, then the -inf-padded 3x3/s2 max-pool."""
    h, w = x12.shape[1:3]
    x = x12.to(dtype).permute(0, 3, 1, 2)                    # NCHW view
    # the conv pads asymmetrically, 2 before and 1 after
    x = F.pad(x, (2, 1, 2, 1))
    k = kernel.to(dtype).permute(3, 2, 0, 1)                 # OIHW
    if dtype == torch.float32:
        y = F.conv2d(x, k)
    else:
        # bf16 operands, f32 sums: products of bf16 values are exact in
        # f32, so an f32 conv of the rounded operands is that function
        y = F.conv2d(x.float(), k.float())
    y = y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
    y = y.clamp_min(0.0).to(dtype)
    y = F.max_pool2d(y, 3, stride=2, padding=1)   # pads with -inf
    return y[:, :, :h // 2, :w // 2].permute(0, 2, 3, 1).contiguous()


def stem_conv_pool_cuda(x12, kernel, scale, bias):
    """Launch the K3 kernel (``csrc/stem_pool.cu``): bf16 in and out."""
    if not x12.is_cuda or x12.dtype != torch.bfloat16 or x12.dim() != 4 \
            or x12.shape[-1] != CIN or not x12.is_contiguous():
        raise ValueError(f'x12 must be a contiguous (B, H, W, {CIN}) bfloat16 '
                         f'CUDA tensor, got {x12.dtype} {tuple(x12.shape)} '
                         f'on {x12.device}')
    b, h, w, _ = x12.shape
    if h % 2 or w % 2:
        raise ValueError(f'stem input height and width must be even, got '
                         f'{h}x{w}')
    if tuple(kernel.shape) != (4, 4, CIN, COUT) \
            or tuple(scale.shape) != (COUT,) or tuple(bias.shape) != (COUT,):
        raise ValueError('kernel must be (4, 4, 12, 64), scale and bias (64,)')
    for t in (kernel, scale, bias):
        if t.device != x12.device:
            raise ValueError('stem weights must be on the input\'s device')
    if x12.data_ptr() % 8:
        raise ValueError('x12 must be 8-byte aligned')
    # the kernel's weight layout: [tap = ky*4 + kx][co][ci, zero-padded
    # from 12 to 16 input channels], bf16
    wpack = F.pad(kernel.reshape(16, CIN, COUT), (0, 0, 0, 16 - CIN))
    wpack = wpack.permute(0, 2, 1).to(torch.bfloat16).contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, h // 2, w // 2, COUT), dtype=torch.bfloat16,
                      device=x12.device)
    _ext.launch('stem_conv_pool', x12.data_ptr(), wpack.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                _ext.current_stream(x12.device))
    return out


def stem_conv_pool(x12, kernel, scale, bias, dtype=torch.bfloat16):
    """The stem. CPU tensors take the plain form; CUDA tensors launch the
    kernel, which computes in bf16 only and raises for another ``dtype``."""
    if x12.is_cuda:
        if dtype != torch.bfloat16:
            raise ValueError(f'the CUDA stem kernel computes in bfloat16, '
                             f'not {dtype}')
        return stem_conv_pool_cuda(x12.to(torch.bfloat16).contiguous(),
                                   kernel, scale, bias)
    return stem_conv_pool_reference(x12, kernel, scale, bias, dtype)
