"""The port's PNG reader and writer (``r3det_tpu_torch.datasets.image_io``)
against OpenCV, the JAX package's image I/O.

``imread`` must equal ``cv2.imread`` bit for bit on PNGs written by
``cv2.imwrite`` (compression 0, 1 and 9) and by PIL (modes L, LA, RGB,
RGBA, P with 256 and 12 colours, 1 and I;16, and 16-bit colour from cv2) at
ragged sizes, made from a numpy seed; the C++ row unfilter must equal the
numpy one on every filter type; ``imwrite`` must round-trip through
``cv2.imread``. Tolerance: none (exact).
"""
import struct
import warnings
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from r3det_tpu_torch.datasets import image_io

SIZES = [(1, 1), (7, 13), (64, 33), (101, 100)]


def _image(rng, h, w):
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    img[h // 2:] = img[h // 2:] // 16 * 16     # smooth rows: more filters
    return img


def _assert_reads_as_cv2(path):
    want = cv2.imread(str(path))
    got = image_io.imread(str(path))
    assert want is not None and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('compression', [0, 1, 9])
def test_imread_matches_cv2_on_cv2_pngs(tmp_path, hw, compression):
    img = _image(np.random.RandomState(hw[0] * 7 + compression), *hw)
    path = tmp_path / 'a.png'
    cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, compression])
    _assert_reads_as_cv2(path)
    np.testing.assert_array_equal(image_io.imread(str(path)), img)


def _pil_image(rng, mode, h, w):
    rgb = _image(rng, h, w)
    grey = rng.randint(0, 256, (h, w), np.uint8)
    if mode == 'L':
        return Image.fromarray(grey, 'L')
    if mode == 'LA':
        return Image.fromarray(np.dstack([grey, grey[::-1]]), 'LA')
    if mode == 'RGB':
        return Image.fromarray(rgb, 'RGB')
    if mode == 'RGBA':
        return Image.fromarray(np.dstack([rgb, grey]), 'RGBA')
    if mode in ('P', 'P12'):
        return Image.fromarray(rgb, 'RGB').convert(
            'P', palette=Image.ADAPTIVE, colors=256 if mode == 'P' else 12)
    if mode == '1':
        return Image.fromarray(grey > 128).convert('1')
    if mode == 'I;16':
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', DeprecationWarning)
            return Image.fromarray(
                rng.randint(0, 65536, (h, w)).astype(np.uint16), 'I;16')
    raise ValueError(mode)


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('mode', ['L', 'LA', 'RGB', 'RGBA', 'P', 'P12', '1',
                                  'I;16'])
def test_imread_matches_cv2_on_pil_pngs(tmp_path, hw, mode):
    path = tmp_path / 'a.png'
    _pil_image(np.random.RandomState(hw[1]), mode, *hw).save(path)
    _assert_reads_as_cv2(path)


@pytest.mark.parametrize('channels', [3, 4])
def test_imread_matches_cv2_on_16_bit_colour(tmp_path, channels):
    rng = np.random.RandomState(channels)
    path = tmp_path / 'a.png'
    cv2.imwrite(str(path),
                rng.randint(0, 65536, (23, 17, channels)).astype(np.uint16))
    _assert_reads_as_cv2(path)


def test_unfilter_matches_numpy_on_every_filter():
    rng = np.random.RandomState(0)
    for bpp, stride in ((1, 9), (3, 30), (4, 44), (6, 18), (8, 64)):
        height = 12
        raw = rng.randint(0, 256, (height, stride + 1), np.uint8)
        raw[:, 0] = np.arange(height) % 5          # all five filter types
        raw = raw.tobytes()
        np.testing.assert_array_equal(
            image_io.unfilter(raw, height, stride, bpp),
            image_io.unfilter_np(raw, height, stride, bpp))


def test_unfilter_rejects_an_unknown_filter():
    raw = bytes([0, 1, 2, 5, 3, 4])
    with pytest.raises(ValueError, match='row 1'):
        image_io.unfilter(raw, 2, 2, 1)


@pytest.mark.parametrize('hw', SIZES)
def test_imwrite_round_trips_through_cv2(tmp_path, hw):
    img = _image(np.random.RandomState(3), *hw)
    path = tmp_path / 'a.png'
    assert image_io.imwrite(str(path), img)
    np.testing.assert_array_equal(cv2.imread(str(path)), img)
    np.testing.assert_array_equal(image_io.imread(str(path)), img)


def test_interlaced_and_other_formats_raise(tmp_path):
    data = bytearray(image_io.encode_png(np.zeros((4, 4, 3), np.uint8)))
    # IHDR body starts at 16; its last byte is the interlace method
    data[28] = 1
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29])))
    path = tmp_path / 'interlaced.png'
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match='interlaced'):
        image_io.imread(str(path))
    jpg = tmp_path / 'a.jpg'
    cv2.imwrite(str(jpg), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(NotImplementedError, match='PNG'):
        image_io.imread(str(jpg))
    assert image_io.imread(str(tmp_path / 'missing.png')) is None
