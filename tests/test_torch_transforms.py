"""The port's test-time transforms (``r3det_tpu_torch.datasets.transforms``)
against the JAX package's, whose ``RResize`` is ``cv2.resize`` with
``INTER_LINEAR``.

``RResize`` must equal it bit for bit, with the same ``scale_factor``,
``img_shape`` and rescaled boxes: 512 -> 1024, 1024 -> 800, 700 -> 1024, an
exact 2x downscale (cv2's area-mean case), odd and non-square sizes, images
of 1 to 3 px. ``Normalize`` and ``Pad`` (fixed canvas and size divisor)
exactly. Images are uint8 BGR from a numpy seed. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from r3det_tpu.datasets import transforms as J
from r3det_tpu_torch.datasets import transforms as T

# (h, w) source, (w, h) img_scale
RESIZE_CASES = [
    ((512, 512), (1024, 1024)),
    ((1024, 1024), (800, 800)),
    ((700, 700), (1024, 1024)),
    ((64, 64), (32, 32)),            # exact 2x down: area mean in cv2
    ((128, 96), (64, 48)),           # exact 2x down, not square
    ((333, 517), (1024, 1024)),
    ((517, 333), (800, 1333)),
    ((99, 77), (50, 30)),
    ((1, 1), (5, 5)),
    ((3, 1), (8, 8)),
    ((2, 3), (1024, 1024)),
    ((3, 3), (2, 2)),
]


def _sample(rng, h, w):
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    boxes = np.stack([rng.uniform(0, w, 5), rng.uniform(0, h, 5),
                      rng.uniform(2, 50, 5), rng.uniform(2, 50, 5),
                      rng.uniform(-1.5, 0, 5)], -1).astype(np.float32)
    return img, boxes


@pytest.mark.parametrize('hw,scale', RESIZE_CASES)
def test_rresize_matches_jax_bit_for_bit(hw, scale):
    img, boxes = _sample(np.random.RandomState(hw[0] + hw[1]), *hw)
    want = J.RResize(scale)(dict(img=img.copy(), gt_bboxes=boxes.copy()))
    got = T.RResize(scale)(dict(img=torch.from_numpy(img),
                                gt_bboxes=boxes.copy()))
    assert got['img'].dtype == torch.uint8
    np.testing.assert_array_equal(got['img'].numpy(), want['img'])
    assert got['img_shape'] == want['img_shape']
    np.testing.assert_array_equal(got['scale_factor'], want['scale_factor'])
    np.testing.assert_array_equal(got['gt_bboxes'], want['gt_bboxes'])


def test_resize_linear_same_size_is_a_copy():
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (9, 7, 3), np.uint8))
    out = T.resize_linear(img, 7, 9)
    assert torch.equal(out, img) and out.data_ptr() != img.data_ptr()
    with pytest.raises(ValueError):
        T.resize_linear(img.float(), 3, 3)


@pytest.mark.parametrize('to_rgb', [True, False])
def test_normalize_matches_jax(to_rgb):
    img = np.random.RandomState(1).randint(0, 256, (37, 53, 3), np.uint8)
    want = J.Normalize(to_rgb=to_rgb)(dict(img=img.copy()))['img']
    got = T.Normalize(to_rgb=to_rgb)(dict(img=torch.from_numpy(img)))['img']
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('kw,hw', [
    (dict(fixed_size=(1024, 1024)), (1000, 700)),
    (dict(fixed_size=(64, 64)), (64, 64)),
    (dict(size_divisor=32), (70, 33)),
    (dict(size_divisor=32, pad_val=3.5), (64, 31)),
])
def test_pad_matches_jax(kw, hw):
    img = np.random.RandomState(2).uniform(-2, 2, hw + (3,)).astype(
        np.float32)
    want = J.Pad(**kw)(dict(img=img.copy()))
    got = T.Pad(**kw)(dict(img=torch.from_numpy(img)))
    np.testing.assert_array_equal(got['img'].numpy(), want['img'])
    assert got['pad_shape'] == want['pad_shape']


def test_pad_rejects_an_image_over_the_canvas():
    with pytest.raises(ValueError, match='canvas'):
        T.Pad(fixed_size=(32, 32))(dict(img=torch.zeros(33, 8, 3)))


def test_pipeline_matches_jax():
    """RResize -> Normalize -> Pad on one 512^2 patch, as the eval loop
    runs them."""
    img, boxes = _sample(np.random.RandomState(3), 512, 512)
    stages = lambda M: [M.RResize((1024, 1024)), M.Normalize(),  # noqa: E731
                        M.Pad(32, fixed_size=(1024, 1024))]
    want = dict(img=img.copy(), gt_bboxes=boxes.copy())
    got = dict(img=torch.from_numpy(img), gt_bboxes=boxes.copy())
    for a, b in zip(stages(J), stages(T)):
        want, got = a(want), b(got)
    np.testing.assert_array_equal(got['img'].numpy(), want['img'])
