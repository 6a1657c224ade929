"""PNG read and write without OpenCV: ``imread`` and ``imwrite``.

Stand-ins for ``cv2.imread(path)`` and ``cv2.imwrite(path, img)`` on PNG
files, the only format of DOTA's images and patches:

- ``imread`` returns what ``cv2.imread`` returns: BGR uint8 (H, W, 3), or
  ``None`` for a missing file. It reads bit depths 1, 2, 4, 8 and 16 in
  the five colour types: grey (0) and grey + alpha (4) repeated into three
  channels, RGB (2) and RGBA (6) reversed to BGR, palette (3) looked up;
  alpha is dropped; 16-bit samples keep their high byte, as libpng's
  ``png_set_strip_16`` (cv2's rule). It raises ``NotImplementedError`` on
  interlaced files and on files that are not PNG.
- ``imwrite`` writes BGR uint8 (H, W, 3) as 8-bit RGB, every row with
  filter 0 (None), deflated by ``zlib``.

Rows are inflated by ``zlib`` and unfiltered by a C++ host helper
(``csrc/host_ops.cpp::png_unfilter``): Sub, Average and Paeth depend on
the byte one pixel to the left, a per-pixel chain. :func:`unfilter_np` is
the plain numpy form it is held to.
"""
import os
import struct
import zlib

import numpy as np

from .. import _host

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError('truncated PNG chunk')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length


def unfilter(raw, height, stride, bpp):
    """Undo the PNG row filters: ``raw`` holds ``height`` rows of a filter
    byte and ``stride`` bytes; returns (height, stride) uint8."""
    raw = np.frombuffer(raw, np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError('truncated PNG image data')
    out = np.empty((height, stride), np.uint8)
    bad = _host.host_ops().png_unfilter(raw.ctypes.data, out.ctypes.data,
                                        height, stride, bpp)
    if bad:
        raise ValueError(f'PNG row {bad - 1} has an unknown filter type')
    return out


def unfilter_np(raw, height, stride, bpp):
    """The plain numpy form of :func:`unfilter` (a loop over bytes for
    Sub, Average and Paeth)."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1).astype(np.int32)
    out = np.zeros((height, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ft, src = rows[y, 0], rows[y, 1:]
        cur = out[y]
        if ft == 0:
            cur[:] = src
        elif ft == 2:
            cur[:] = (src + prev) & 255
        elif ft in (1, 3, 4):
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 255
        else:
            raise ValueError(f'PNG row {y} has an unknown filter type')
        prev = cur
    return out.astype(np.uint8)


def _samples(rows, width, channels, depth):
    """Unfiltered rows -> (H, W, channels) samples (uint8 or uint16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2].view('>u2').reshape(
            h, width, channels)
    # 1, 2, 4 bits: one channel (grey or palette index), MSB first
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, width, depth) * weights).sum(
        -1, dtype=np.uint8)[..., None]


def decode_png(data):
    """PNG bytes -> BGR uint8 (H, W, 3), ``cv2.imread``'s result."""
    if not data.startswith(PNG_SIGNATURE):
        raise NotImplementedError('image_io reads PNG files only')
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without IHDR')
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError('interlaced PNG files are not supported')
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and ctype not in (0, 3)) or (depth == 16 and ctype == 3):
        raise ValueError(f'invalid PNG: bit depth {depth}, colour type '
                         f'{ctype}')
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b''.join(idat))
    s = _samples(unfilter(raw, height, stride, bpp), width, channels, depth)
    if ctype == 3:
        if palette is None:
            raise ValueError('palette PNG without PLTE')
        rgb = palette[np.minimum(s[..., 0], len(palette) - 1)]
        return np.ascontiguousarray(rgb[..., ::-1])
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    elif depth < 8:                       # grey: scale to 0..255
        s = (s.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    if ctype in (0, 4):
        return np.ascontiguousarray(np.repeat(s[..., :1], 3, axis=-1))
    return np.ascontiguousarray(s[..., 2::-1])


def imread(path):
    """``cv2.imread(path)`` for PNG: BGR uint8 (H, W, 3); ``None`` when
    the file does not exist."""
    if not os.path.isfile(path):
        return None
    with open(path, 'rb') as f:
        return decode_png(f.read())


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def encode_png(img):
    """BGR uint8 (H, W, 3) -> PNG bytes (8-bit RGB, filter 0, deflate
    level 1, cv2.imwrite's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'imwrite takes BGR uint8 (H, W, 3), got '
                         f'{img.dtype} {img.shape}')
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)          # filter byte 0
    rows[:, 1:] = img[..., ::-1].reshape(h, 3 * w)
    header = struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(rows.tobytes(), 1)) +
            _chunk(b'IEND', b''))


def imwrite(path, img):
    """``cv2.imwrite(path, img)`` for PNG; returns True."""
    data = encode_png(img)
    with open(path, 'wb') as f:
        f.write(data)
    return True
