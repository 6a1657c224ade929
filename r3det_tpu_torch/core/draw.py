"""Rotated-box drawing without OpenCV: contours and captions on BGR uint8.

``draw_contours`` is ``cv2.drawContours(img, polys, -1, color,
thickness)`` with ``LINE_8``, pixel for pixel, as OpenCV 5.0 draws it
(``imgproc/src/drawing.cpp``; ``tests/test_torch_visualization.py``
holds it to cv2): every edge of a closed contour, the last back to the
first, goes through ``ThickLine``:

- thickness 1: ``clipLine`` and the 8-connected ``LineIterator``
  (Bresenham, drawn left to right);
- thickness above 1: the edge clipped to the image grown by the
  thickness, then widened into a quad in ``XY_SHIFT = 16`` fixed point,
  filled by ``FillConvexPoly`` (its outline by ``Line2``, then the
  scanline fill), and a filled ``Circle`` at the edge's end, the round
  joint.

The integer arithmetic is OpenCV's: int64 fixed point, C division that
truncates toward zero, ``cvRound`` to even, and the int32 casts that
wrap (a NaN box's ``astype(np.int32)`` corners are ``INT_MIN``; OpenCV
then draws nothing, and neither does this). A scanline fill over rows
above the image runs in closed form instead of row by row.

``put_text`` writes a caption in an aliased 5x7 bitmap font of its own,
ASCII 32-126. OpenCV 5.0 renders ``FONT_HERSHEY_COMPLEX`` anti-aliased
through its own font engine, so the captions are not cv2's pixels; they
keep cv2's anchor and colour and lie inside the box that
``cv2.getTextSize(text, FONT_HERSHEY_COMPLEX, 0.5, 1)`` gives at the
anchor, which ``text_size`` returns without cv2.
"""
import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _i32(v):
    """C's ``(int)`` of an int64 (a Python int or an int64 array): wraps
    into int32."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _cdiv(a, b):
    """C's integer division: truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width, height, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on int64 points (``Size2l``): returns
    ``(inside, x1, y1, x2, y2)``; the second end is clipped with the first
    end's clipped coordinates, as OpenCV does."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


class _Pixels:
    """The pixels one contour sets: points and horizontal spans, clipped
    to a (height, width) image."""

    def __init__(self, height, width):
        self.height, self.width = height, width
        self.ys, self.xs = [], []

    def points(self, xs, ys):
        keep = (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
        self.xs.append(xs[keep])
        self.ys.append(ys[keep])

    def spans(self, ys, x1, x2):
        """Rows ``ys`` from ``x1`` to ``x2`` inclusive, already clipped."""
        n = np.maximum(x2 - x1 + 1, 0)
        if not n.sum():
            return
        row = np.repeat(np.arange(len(ys)), n)
        start = np.cumsum(n) - n
        self.ys.append(np.asarray(ys, np.int64)[row])
        self.xs.append(np.asarray(x1, np.int64)[row] +
                       np.arange(n.sum()) - start[row])

    def paint(self, img, color):
        if self.xs:
            img[np.concatenate(self.ys), np.concatenate(self.xs)] = color


def _line(px, x1, y1, x2, y2):
    """OpenCV's ``Line`` (8-connected ``LineIterator``, left to right)
    between int32 points."""
    ok, x1, y1, x2, y2 = _clip_line(px.width, px.height, x1, y1, x2, y2)
    if not ok:
        return
    x1, y1, x2, y2 = _i32(x1), _i32(y1), _i32(x2), _i32(y2)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    m = (2 * dy * k + dx - 1) // (2 * dx) if dx else k
    if vert:
        px.points(x1 + m, y1 + sy * k)
    else:
        px.points(x1 + k, y1 + sy * m)


def _line2(px, x1, y1, x2, y2):
    """OpenCV's ``Line2``, the outline edge of ``FillConvexPoly``: the
    8-connected line between two ``XY_SHIFT`` fixed-point points."""
    ok, x1, y1, x2, y2 = _clip_line(px.width << XY_SHIFT,
                                    px.height << XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = _i32((x2 - x1) >> XY_SHIFT)
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = _i32((y2 - y1) >> XY_SHIFT)
    x1 += _HALF
    y1 += _HALF
    px.points(np.array([_i32((x2 + _HALF) >> XY_SHIFT)]),
              np.array([_i32((y2 + _HALF) >> XY_SHIFT)]))
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        px.points((x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT)
    else:
        px.points((x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k)


def _fill_convex_poly(px, v):
    """OpenCV's ``FillConvexPoly`` of ``v`` ((n, 2) int64 in ``XY_SHIFT``
    fixed point, ``LINE_8``): the outline by ``Line2``, then the scanline
    fill between the two edges that walk down from the top vertex."""
    v = [(int(x), int(y)) for x, y in v]
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line2(px, p0[0], p0[1], p[0], p[1])
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin = (min(p[0] for p in v) + _HALF) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + _HALF) >> XY_SHIFT
    ymin = (min(ys) + _HALF) >> XY_SHIFT
    ymax = (max(ys) + _HALF) >> XY_SHIFT
    if (n < 3 or _i32(xmax) < 0 or _i32(ymax) < 0 or
            _i32(xmin) >= px.width or _i32(ymin) >= px.height):
        return
    ymax = _i32(min(ymax, px.height - 1))
    y = _i32(ymin)
    # [idx, di, x, dx, ye] of the left-going and right-going edges
    edge = [[imin, 1, -XY_ONE, 0, y], [imin, n - 1, -XY_ONE, 0, y]]
    edges = n
    rows_y, rows_a, rows_b = [], [], []
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while edges > 0:
                edges -= 1
                ty = _i32((v[idx][1] + _HALF) >> XY_SHIFT)
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[4] = ty
                    e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0 = idx
                idx = (idx + e[1]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        first = max(y, 0)                  # rows above the image: skipped
        if stop > first:
            k = np.arange(first - y, stop - y, dtype=np.int64)
            rows_y.append(np.arange(first, stop, dtype=np.int64))
            rows_a.append(edge[0][2] + k * edge[0][3])
            rows_b.append(edge[1][2] + k * edge[1][3])
        for e in edge:
            e[2] += (stop - y) * e[3]
        y = stop
        if y > ymax:
            break
    if not rows_y:
        return
    a, b = np.concatenate(rows_a), np.concatenate(rows_b)
    left, right = np.minimum(a, b), np.maximum(a, b)
    x1 = _i32((left + _HALF) >> XY_SHIFT)
    x2 = _i32((right + _HALF) >> XY_SHIFT)
    keep = (x2 >= 0) & (x1 < px.width)
    px.spans(np.concatenate(rows_y)[keep], np.maximum(x1[keep], 0),
             np.minimum(x2[keep], px.width - 1))


def _circle(px, cx, cy, radius):
    """OpenCV's filled ``Circle``: the spans its midpoint loop draws."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    rows, x1, x2 = [], [], []
    while dx >= dy:
        for r, h in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                     (cy + dx, dy)):
            r, lo, hi = _i32(r), _i32(cx - h), _i32(cx + h)
            if 0 <= r < px.height and lo < px.width and hi >= 0:
                rows.append(r)
                x1.append(max(lo, 0))
                x2.append(min(hi, px.width - 1))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    if rows:
        px.spans(np.array(rows), np.array(x1), np.array(x2))


def _thick_line(px, p0, p1, thickness):
    """OpenCV's ``ThickLine`` with ``LINE_8``, shift 0 and the end-joint
    flag that ``drawContours`` passes (a round joint at ``p1`` only)."""
    if thickness <= 1:
        _line(px, p0[0], p0[1], p1[0], p1[1])
        return
    # OpenCV 5.0 first clips the edge, in int64, to the image grown by the
    # thickness on every side
    m = thickness
    ok, x0, y0, x1, y1 = _clip_line(
        px.width + 2 * m, px.height + 2 * m, p0[0] + m, p0[1] + m,
        p1[0] + m, p1[1] + m)
    if not ok:
        return
    x0, y0 = (x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT
    x1, y1 = (x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT
    dx = (x0 - x1) * (1.0 / XY_ONE)
    dy = (y1 - y0) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(px, ((x0 + ddx, y0 + ddy), (x0 - ddx, y0 - ddy),
                               (x1 - ddx, y1 - ddy), (x1 + ddx, y1 + ddy)))
    _circle(px, _i32((x1 + _HALF) >> XY_SHIFT),
            _i32((y1 + _HALF) >> XY_SHIFT), (t + _HALF) >> XY_SHIFT)


def draw_contours(img, polys, color, thickness=1):
    """``cv2.drawContours(img, polys, -1, color, thickness)`` (``LINE_8``,
    no hierarchy; thickness 0 draws as 1) in place on a BGR uint8 (H, W,
    3) image; returns it.

    ``polys`` is a sequence of (n, 2) int32 polygons, each drawn closed.
    """
    if not 0 <= thickness <= 32767:
        raise ValueError(f'thickness must lie in [0, 32767], got '
                         f'{thickness} (filled contours are not ported)')
    h, w = img.shape[:2]
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in
               np.asarray(poly, np.int32).reshape(-1, 2)]
        px = _Pixels(h, w)
        for j, p in enumerate(pts):
            _thick_line(px, p, pts[(j + 1) % len(pts)], thickness)
        px.paint(img, color)
    return img


# ---------------------------------------------------------------------------
# Captions
# ---------------------------------------------------------------------------

# A 5x7 font, ASCII 32-126: one glyph a line, columns left to right, bit
# r of a column set where row r (0 at the top, 6 on the baseline) is ink.
_GLYPHS = (
    '', '5f', '07,00,07', '14,7f,14,7f,14', '24,2a,7f,2a,12',
    '23,13,08,64,62', '36,49,56,20,50', '05,03', '1c,22,41', '41,22,1c',
    '14,08,3e,08,14', '08,08,3e,08,08', '50,30', '08,08,08,08,08', '60,60',
    '20,10,08,04,02', '3e,51,49,45,3e', '42,7f,40', '42,61,51,49,46',
    '21,41,45,4b,31', '18,14,12,7f,10', '27,45,45,45,39', '3c,4a,49,49,30',
    '01,71,09,05,03', '36,49,49,49,36', '06,49,49,29,1e', '36,36', '56,36',
    '08,14,22,41', '14,14,14,14,14', '41,22,14,08', '02,01,51,09,06',
    '32,49,79,41,3e', '7e,11,11,11,7e', '7f,49,49,49,36', '3e,41,41,41,22',
    '7f,41,41,22,1c', '7f,49,49,49,41', '7f,09,09,09,01', '3e,41,49,49,7a',
    '7f,08,08,08,7f', '41,7f,41', '20,40,41,3f,01', '7f,08,14,22,41',
    '7f,40,40,40,40', '7f,02,0c,02,7f', '7f,04,08,10,7f', '3e,41,41,41,3e',
    '7f,09,09,09,06', '3e,41,51,21,5e', '7f,09,19,29,46', '46,49,49,49,31',
    '01,01,7f,01,01', '3f,40,40,40,3f', '1f,20,40,20,1f', '3f,40,38,40,3f',
    '63,14,08,14,63', '07,08,70,08,07', '61,51,49,45,43', '7f,41,41',
    '02,04,08,10,20', '41,41,7f', '04,02,01,02,04', '40,40,40,40,40',
    '01,02,04', '20,54,54,54,78', '7f,48,44,44,38', '38,44,44,44,20',
    '38,44,44,48,7f', '38,54,54,54,18', '08,7e,09,02', '0c,52,52,52,3e',
    '7f,08,04,04,78', '7d', '40,3d', '7f,10,28,44', '7f', '7c,04,18,04,78',
    '7c,08,04,04,78', '38,44,44,44,38', '7c,14,14,14,08', '08,14,14,18,7c',
    '7c,08,04,04', '48,54,54,54,20', '04,3f,44,20', '3c,40,40,20,7c',
    '1c,20,40,20,1c', '3c,40,30,40,3c', '44,28,10,28,44', '0c,50,50,50,3c',
    '44,64,54,4c,44', '08,36,41', '7f', '41,36,08', '08,04,08,10,08',
)
_GLYPH_COLUMNS = [
    np.array([int(c, 16) for c in g.split(',')] if g else [], np.int64)
    for g in _GLYPHS]

# cv2.getTextSize at FONT_HERSHEY_COMPLEX, scale 0.5, thickness 1, ASCII
# 32-126: a string is the sum of its glyphs' advances plus 1 wide, 14
# high, and its baseline is its deepest glyph's descent.
_ADVANCE = (
    3, 3, 5, 10, 9, 11, 10, 3, 9, 9, 6, 9, 3, 7, 3, 7, 9, 9, 9, 9, 9, 9, 9,
    9, 9, 9, 3, 4, 7, 8, 7, 7, 12, 10, 10, 9, 10, 9, 8, 10, 10, 4, 9, 9, 8,
    11, 10, 10, 9, 10, 9, 9, 8, 10, 9, 11, 9, 9, 8, 4, 7, 4, 6, 11, 5, 8,
    8, 8, 8, 8, 5, 8, 9, 3, 3, 7, 3, 13, 9, 8, 8, 8, 5, 7, 5, 9, 8, 12, 8,
    8, 7, 5, 3, 5, 8)
_DESCENT = (
    0, 0, 0, 0, 2, 1, 1, 0, 2, 2, 0, 0, 2, 0, 0, 2, 1, 0, 0, 1, 0, 1, 1, 0,
    1, 0, 0, 2, 0, 0, 0, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 3, 2, 3, 0, 1, 0, 1, 1, 1, 1, 1, 0, 4,
    0, 0, 3, 0, 0, 0, 0, 1, 3, 3, 0, 1, 0, 1, 0, 0, 0, 3, 0, 3, 4, 3, 0)
_HEIGHT = 14
_BASE_SCALE = 0.5


def _codes(text):
    codes = [ord(c) - 32 for c in text]
    if any(not 0 <= c < len(_GLYPHS) for c in codes):
        raise ValueError(f'put_text draws ASCII 32-126 only: {text!r}')
    return codes


def text_size(text, font_scale=_BASE_SCALE):
    """``cv2.getTextSize(text, FONT_HERSHEY_COMPLEX, font_scale, 1)``:
    ``((width, height), baseline)``. Equal to cv2 at scale 0.5; at other
    scales the 0.5 metrics times ``font_scale / 0.5``, rounded up."""
    codes = _codes(text)
    if not codes:
        return (0, 0), 0
    f = font_scale / _BASE_SCALE
    width = sum(_ADVANCE[c] for c in codes)
    return ((math.ceil(width * f) + 1, math.ceil(_HEIGHT * f)),
            math.ceil(max(_DESCENT[c] for c in codes) * f))


def put_text(img, text, org, font_scale=_BASE_SCALE, color=(255, 255, 255)):
    """Draw ``text`` with its baseline's left end at ``org`` (x, y), in
    place on a BGR uint8 image; returns it. The 5x7 glyphs are scaled by
    ``font_scale / 0.5`` (nearest pixel) and their ink lies inside the
    ``text_size`` box: x in [org.x, org.x + width), y in
    [org.y - height, org.y + baseline]."""
    h, w = img.shape[:2]
    f = font_scale / _BASE_SCALE
    x0, y0 = int(org[0]), int(org[1])
    px = _Pixels(h, w)
    pen = 0
    for c in _codes(text):
        cols = _GLYPH_COLUMNS[c]
        if len(cols):
            gw, gh = math.ceil(len(cols) * f), math.ceil(7 * f)
            u = np.arange(gw) * len(cols) // gw       # source column
            v = np.arange(gh) * 7 // gh               # source row
            ink = (cols[u][None, :] >> v[:, None]) & 1
            ry, rx = np.nonzero(ink)
            px.points(x0 + math.floor(pen * f) + rx, y0 - gh + ry)
        pen += _ADVANCE[c]
    px.paint(img, color)
    return img
