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
from r3det_tpu_torch.ops import frm_sample as K2
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
def test_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    x = torch.zeros(1, 8, 8, 12, device=cuda)             # f32, not bf16
    k = torch.zeros(4, 4, 12, 64, device=cuda)
    s = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        K3.stem_conv_pool(x, k, s, s, dtype=torch.float32)
    b = torch.zeros(1, 5, 8, device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        K1.rotated_iou_cuda(b, b)
