"""The port's drawing (``core/draw.py``, ``core/visualization.py``) against
OpenCV 5.0 and the JAX package, on the CPU.

- ``draw_contours`` equals ``cv2.drawContours(img, [poly], 0, color,
  thickness)`` (``LINE_8``) bit for bit at thickness 1, 2 and 3, on 360
  seeded polygons a thickness over images of seeded sizes: inside,
  crossing the border, far outside (up to +-2^30), degenerate (a point, a
  segment, repeated vertices), with ``INT_MIN`` corners (a NaN box's
  ``astype(np.int32)``), and of 1 to 8 vertices.
- ``text_size`` equals ``cv2.getTextSize(text, FONT_HERSHEY_COMPLEX, 0.5,
  1)`` for every glyph and seeded strings.
- ``imshow_det_rbboxes`` equals the JAX function on every pixel outside
  the caption boxes (each ``cv2.getTextSize`` box at its anchor, grown by
  1 px) on seeded scenes of 5- and 6-column boxes, with and without class
  names; each caption reads ``label|score`` at its first corner's anchor,
  and its ink is its palette colour and lies inside that box (also for
  every glyph); the PNG it writes decodes with cv2 to the array it
  returns.
- ``show=True`` raises.
"""
import cv2
import numpy as np
import pytest

from r3det_tpu.core import visualization as JV
from r3det_tpu_torch.core import draw as D
from r3det_tpu_torch.core import visualization as TV

FONT = cv2.FONT_HERSHEY_COMPLEX
INT_MIN = np.iinfo(np.int32).min
SLACK = 1


def _polygons(rng, n, h, w):
    """``n`` int32 polygons of every kind, cycled."""
    out = []
    for i in range(n):
        kind = i % 8
        if kind == 0:                                  # around the image
            p = rng.randint(-w // 4, w + w // 4, (4, 2))
        elif kind == 1:                                # far outside
            p = rng.randint(-3000, 3000, (4, 2))
        elif kind == 2:
            p = rng.randint(-2 ** 30, 2 ** 30, (4, 2))
        elif kind == 3:                                # a point
            p = np.repeat(rng.randint(-5, w + 5, (1, 2)), 4, 0)
        elif kind == 4:                                # a segment, repeated
            p = rng.randint(-5, w + 5, (2, 2))[[0, 1, 1, 0]]
        elif kind == 5:                                # a NaN corner
            p = rng.randint(0, w, (4, 2))
            p[rng.randint(4)] = INT_MIN
        elif kind == 6:                                # 1 to 8 vertices
            p = rng.randint(-5, w + 5, (rng.randint(1, 9), 2))
        else:                                          # a rotated box
            c = rng.uniform(0, w, 2)
            bw, bh = rng.uniform(1, 0.8 * w, 2)
            a = rng.uniform(-np.pi, np.pi)
            box = np.array([[c[0], c[1], bw, bh, a, 1.0]], np.float32)
            p = TV.obb2poly_np_v1(box)[0, :8].reshape(4, 2)
        out.append(p.astype(np.int32))
    return out


@pytest.mark.parametrize('thickness', [1, 2, 3])
def test_draw_contours_equals_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for i, poly in enumerate(_polygons(rng, 360, 64, 80)):
        h, w = rng.randint(1, 90, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.drawContours(img.copy(), [poly], 0, color, thickness)
        got = D.draw_contours(img.copy(), [poly], color, thickness)
        assert np.array_equal(got, want), (i, poly.tolist(), (h, w))


def test_text_size_equals_cv2():
    rng = np.random.RandomState(0)
    texts = [chr(c) for c in range(32, 127)] + [
        ''.join(chr(c) for c in rng.randint(32, 127, rng.randint(1, 24)))
        for _ in range(300)] + ['plane|0.90', 'small-vehicle|1.00', '7|0.31']
    for text in texts:
        assert D.text_size(text) == cv2.getTextSize(text, FONT, 0.5, 1), text


def record_captions(monkeypatch):
    """Record every caption the port draws: (text, org, scale, colour)
    in ``calls``, and under each written file's path the calls made
    since the last file, in ``files``."""
    calls, files = [], {}

    def put_text(img, text, org, font_scale=0.5, color=(255, 255, 255)):
        calls.append((text, tuple(org), font_scale, tuple(color)))
        return D.put_text(img, text, org, font_scale, color)

    def imwrite(path, img):
        files[path] = list(calls)
        calls.clear()
        return real_imwrite(path, img)
    real_imwrite = TV.imwrite
    monkeypatch.setattr(TV, 'put_text', put_text)
    monkeypatch.setattr(TV, 'imwrite', imwrite)
    return calls, files


def caption_mask(shape, captions):
    """True inside every caption's ``cv2.getTextSize`` box (x in
    [org.x, org.x + w), y in [org.y - h, org.y + baseline]), grown by
    SLACK px."""
    mask = np.zeros(shape[:2], bool)
    for text, (x, y), scale, _ in captions:
        (w, h), base = cv2.getTextSize(text, FONT, scale, 1)
        mask[max(y - h - SLACK, 0):max(y + base + SLACK + 1, 0),
             max(x - SLACK, 0):max(x + w + SLACK, 0)] = True
    return mask


def _scene(rng, n, cols, h=240, w=320):
    boxes = np.stack([rng.uniform(-20, w + 20, n), rng.uniform(-20, h + 20, n),
                      rng.uniform(4, 90, n), rng.uniform(4, 60, n),
                      rng.uniform(-np.pi / 2, np.pi / 2, n),
                      rng.uniform(0, 1, n)], -1)[:, :cols]
    labels = rng.randint(0, 20, n)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return img, boxes.astype(np.float32), labels


@pytest.mark.parametrize('cols,names,thr', [(6, True, 0.3), (6, False, 0.0),
                                            (5, True, 0.3), (5, False, 0.5)])
def test_imshow_det_rbboxes_matches_jax(tmp_path, monkeypatch, cols, names,
                                        thr):
    rng = np.random.RandomState(cols * 10 + int(names))
    img, boxes, labels = _scene(rng, 16, cols)
    class_names = [f'class{i}' for i in range(20)] if names else None
    calls, files = record_captions(monkeypatch)
    out = str(tmp_path / 'out.png')
    got = TV.imshow_det_rbboxes(img.copy(), boxes, labels, class_names,
                                score_thr=thr, out_file=out)
    want = JV.imshow_det_rbboxes(img.copy(), boxes, labels, class_names,
                                 score_thr=thr)
    captions = files[out]
    kept = (boxes[:, 5] >= thr) if cols == 6 and thr > 0 else \
        np.ones(len(boxes), bool)
    assert len(captions) == kept.sum()
    for (text, org, scale, color), box, label in zip(
            captions, boxes[kept], labels[kept]):
        score = box[5] if cols == 6 else 1.0
        name = class_names[label] if names else str(label)
        assert text == f'{name}|{score:.02f}'
        assert color == TV.PALETTE[label % 16]
        poly = TV.obb2poly_np_v1(np.concatenate(
            [box[:5], [score]])[None].astype(np.float32))[0]
        assert org == (int(poly[0]), int(poly[1]) - 3)
        assert_caption_in_box(img.shape, text, org, scale, color)
    outside = ~caption_mask(img.shape, captions)
    assert outside.mean() > 0.5
    assert np.array_equal(got[outside], want[outside])
    assert np.array_equal(cv2.imread(out), got)


def assert_caption_in_box(shape, text, org, scale, color):
    """The caption drawn alone: ink of ``color`` only, all of it inside
    its ``cv2.getTextSize`` box (SLACK px of slack)."""
    img = np.zeros(shape, np.uint8)
    D.put_text(img, text, org, scale, color)
    ink = img.any(-1)
    assert (img[ink] == color).all(), text
    assert not (ink & ~caption_mask(shape, [(text, org, scale, color)])
                ).any(), (text, org)
    return ink


def test_caption_ink_lies_in_its_box_in_its_colour():
    rng = np.random.RandomState(1)
    texts = ['plane|0.90', 'small-vehicle|1.00', 'gjpqy|@{}', '_|W',
             '0|0.05'] + [''.join(chr(c) for c in range(s, min(s + 19, 127)))
                          for s in range(32, 127, 19)]
    for text in texts:
        org = (int(rng.randint(0, 40)), int(rng.randint(20, 40)))
        ink = assert_caption_in_box((60, 200, 3), text, org, 0.5,
                                    TV.PALETTE[rng.randint(16)])
        assert ink.any(), text


def test_show_raises():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(NotImplementedError):
        TV.imshow_det_rbboxes(img, np.zeros((0, 5), np.float32),
                              np.zeros(0, int), show=True)
