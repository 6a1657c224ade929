"""Each CUDA kernel of r3det_tpu_torch against its plain PyTorch version, on
a card. Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Every test skips without a CUDA card (decided in the fixture). f32
comparisons run with TF32 off.
"""
import math

import numpy as np
import pytest
import torch

from r3det_tpu_torch import _ext
from r3det_tpu_torch.ops import bottleneck_fuse as K5
from r3det_tpu_torch.ops import frm_sample as K2
from r3det_tpu_torch.ops import int8_conv as Q
from r3det_tpu_torch.ops import rotated_iou as K1
from r3det_tpu_torch.ops import stem_pool as K3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', torch.cuda.current_device())


def boxes(rng, b, n):
    out = np.stack([rng.uniform(0, 200, (b, n)), rng.uniform(0, 200, (b, n)),
                    rng.uniform(5, 60, (b, n)), rng.uniform(5, 60, (b, n)),
                    rng.uniform(-math.pi, math.pi, (b, n))], -1)
    out[:, 1] = out[:, 0]                             # identical pair
    return torch.from_numpy(out.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize('n,m', [(70, 90), (300, 300)])
def test_rotated_iou_kernel_matches_plain(cuda, n, m):
    rng = np.random.RandomState(n)
    b1, b2 = boxes(rng, 2, n).to(cuda), boxes(rng, 2, m).to(cuda)
    vc = torch.tensor([n, n // 3], dtype=torch.int32, device=cuda)
    before = _ext.LAUNCHES['rotated_iou']
    for args, kw in (((b1, b2), {}), ((b1, b2), dict(mode='iof')),
                     ((b1, b1), dict(upper_only=True, valid_count=vc))):
        got = K1.rotated_iou(*args, **kw)
        want = K1.rotated_iou_reference(*args, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert _ext.LAUNCHES['rotated_iou'] == before + 3


@pytest.mark.gpu
def test_frm_sample_kernel_matches_plain(cuda):
    rng = np.random.RandomState(2)
    b, h, w, c, stride = 2, 16, 16, 256, 8
    rois = np.stack([rng.uniform(-20, 150, (b, h * w)),
                     rng.uniform(-20, 150, (b, h * w)),
                     rng.uniform(8, 64, (b, h * w)),
                     rng.uniform(8, 64, (b, h * w)),
                     rng.uniform(-1, 1, (b, h * w))], -1).astype(np.float32)
    rois = torch.from_numpy(rois).to(cuda)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    for quirk in (True, False):
        # same operation order and roundings as the plain form: bit-equal
        got = K2.frm_sample(x, feat, rois, 1 / stride, quirk)
        want = K2.frm_sample_reference(x, feat, rois, 1 / stride, quirk)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        K2.frm_sample(x.float(), feat.float(), rois, 1 / stride)


@pytest.mark.gpu
def test_stem_kernel_matches_plain(cuda):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.uniform(-2, 2, (2, 64, 48, 12))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    k, s, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.normal(0, 0.1, (4, 4, 12, 64)), rng.uniform(0.5, 2, 64),
        rng.uniform(-1, 1, 64)))
    got = K3.stem_conv_pool(x, k, s, b).float()
    want = K3.stem_conv_pool_reference(x, k, s, b).float()
    assert tuple(got.shape) == (2, 32, 24, 64)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_stem_q8_kernel_matches_plain(cuda):
    """K3 int8: exact int32 sums and the plain version's epilogue order, so
    within one bf16 ulp (the f32 factor is formed once per channel)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.uniform(-2, 2, (2, 64, 48, 12))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    k, s, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.normal(0, 0.1, (4, 4, 12, 64)), rng.uniform(0.5, 2, 64),
        rng.uniform(-1, 1, 64)))
    before = _ext.LAUNCHES['stem_conv_pool_q8']
    got = K3.stem_conv_pool(x, k, s, b, quantize=True).float()
    want = K3.stem_conv_pool_q8_reference(x, k, s, b).float()
    assert _ext.LAUNCHES['stem_conv_pool_q8'] == before + 1
    assert tuple(got.shape) == (2, 32, 24, 64)
    assert bool(((got - want).abs() <= want.abs() * 2 ** -7 + 1e-6).all())


@pytest.mark.gpu
def test_stem_pool_kernel_matches_plain(cuda):
    """K4: a max of bf16 values, bit-equal; odd sizes cover the edges."""
    rng = np.random.RandomState(7)
    y = torch.from_numpy(rng.randn(2, 33, 46, 64).astype(np.float32)).to(
        cuda, torch.bfloat16)
    got = K3.stem_pool(y)
    assert torch.equal(got, K3.stem_pool_reference(y))
    assert tuple(got.shape) == (2, 16, 23, 64)


def bottleneck_args(rng, f, dev):
    c4 = 4 * f
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 20, c4))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    ws = [torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))
          .to(dev) for shape, std in (
              ((1, 1, c4, f), c4 ** -0.5), ((f,), 0.1),
              ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 0.1),
              ((1, 1, f, c4), f ** -0.5), ((c4,), 0.1))]
    return x, ws


@pytest.mark.gpu
@pytest.mark.parametrize('f', [64, 128, 256])
def test_bottleneck_kernel_matches_plain(cuda, f):
    """K5 bf16: f32 sums in another order round a few bf16 intermediates
    the other way: atol 0.05 (the JAX package's bound) + 1e-2 relative.
    W = 20 leaves a ragged 8-column tile."""
    x, ws = bottleneck_args(np.random.RandomState(f), f, cuda)
    got = K5.fused_bottleneck(x, *ws).float()
    want = K5.fused_bottleneck_reference(x, *ws).float()
    assert bool(((got - want).abs() <= 0.05 + 1e-2 * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize('f', [64, 128, 256])
def test_bottleneck_q8_kernel_matches_plain(cuda, f):
    """K5 int8: exact int32 sums, the same f32 epilogue: atol 2e-2 (the JAX
    package's bound)."""
    x, ws = bottleneck_args(np.random.RandomState(f + 1), f, cuda)
    amax = [x.float().abs().amax(), torch.tensor(3.0, device=cuda),
            torch.tensor(2.5, device=cuda)]
    before = _ext.LAUNCHES['bottleneck_q8']
    got = K5.fused_bottleneck_q8(x, *ws, *amax).float()
    want = K5.fused_bottleneck_q8_reference(x, *ws, *amax).float()
    assert _ext.LAUNCHES['bottleneck_q8'] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize('shape,kernel,stride,pad,co,int8_in,bias', [
    ((2, 17, 13, 64), (3, 3), (1, 1), (1, 1), 64, False, True),
    ((2, 16, 16, 256), (1, 1), (2, 2), (0, 0), 512, True, False),
    ((2, 9, 11, 256), (1, 5), (1, 1), (0, 2), 256, False, True),
    ((2, 9, 11, 256), (5, 1), (1, 1), (2, 0), 256, False, True),
    ((1, 10, 10, 32), (3, 3), (2, 2), (1, 1), 64, True, True),
])
def test_int8_conv_kernel_matches_plain(cuda, shape, kernel, stride, pad, co,
                                        int8_in, bias):
    """QConv's int8 conv kernel: exact int32 sums and the plain version's
    dequant order, so bit-equal, for bf16 and int8 (pre-quantized) input."""
    rng = np.random.RandomState(co + shape[1])
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        cuda, torch.bfloat16)
    ascale = x.float().abs().amax() / 127.0
    if int8_in:
        x = Q.quantize_act(x, ascale)
    w = torch.from_numpy(rng.normal(0, 0.1, kernel + (shape[3], co))
                         .astype(np.float32)).to(cuda)
    wi, ks = Q.quantize_weights(w, axes=(0, 1, 2))
    b = torch.from_numpy(rng.normal(0, 1, co).astype(np.float32)).to(
        cuda) if bias else None
    args = (x, ascale, wi, ks.reshape(-1), b, stride, pad)
    before = _ext.LAUNCHES['int8_conv']
    got = Q.qconv(*args, torch.bfloat16)
    want = Q.qconv_reference(*args, torch.bfloat16)
    assert _ext.LAUNCHES['int8_conv'] == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
def test_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    x = torch.zeros(1, 8, 8, 12, device=cuda)             # f32, not bf16
    k = torch.zeros(4, 4, 12, 64, device=cuda)
    s = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        K3.stem_conv_pool(x, k, s, s, dtype=torch.float32)
    b = torch.zeros(1, 5, 8, device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        K1.rotated_iou_cuda(b, b)
    x, ws = bottleneck_args(np.random.RandomState(0), 32, cuda)
    with pytest.raises(ValueError):                        # F = 32
        K5.fused_bottleneck(x, *ws)
