"""Generate a synthetic DOTA-format dataset and its patch split.

    python -m r3det_tpu_torch.tools.make_fake_dota [--num-images 6]

The counterpart of ``tools/misc/make_fake_dota.py`` without OpenCV, with
its arguments, defaults, random draws and output layout: rotated solid-
colour boxes of 3 classes painted onto noise images, DOTA labelTxt
polygons, then the port's splitter at 512 with gap 128, into the layout
``configs/debug/*_fake_dota.py`` read (``/tmp/fake_dota_split/trainval``
by default). A box's corners are computed from the box in numpy (the
formula of ``cv2.boxPoints``), and its fill is a point-in-polygon test on
pixel centres, so an image may differ from the JAX maker's by edge pixels.
"""
import argparse
import math
import os

import numpy as np

from . import img_split
from ..datasets.image_io import imwrite

CLASSES = ('plane', 'ship', 'small-vehicle')


def box_points(cx, cy, w, h, angle_deg):
    """The four corners of a rotated box, (4, 2) float32 in
    ``cv2.boxPoints``'s order."""
    a = float(np.float32(angle_deg)) * math.pi / 180
    b = np.float32(math.cos(a)) * np.float32(0.5)
    s = np.float32(math.sin(a)) * np.float32(0.5)
    c = np.float32([cx, cy])
    w, h = np.float32(w), np.float32(h)
    p0 = np.float32([c[0] - s * h - b * w, c[1] + b * h - s * w])
    p1 = np.float32([c[0] + s * h - b * w, c[1] - b * h - s * w])
    return np.stack([p0, p1, 2 * c - p0, 2 * c - p1]).astype(np.float32)


def fill_convex(img, pts, color):
    """Paint the pixels whose centres lie in the convex polygon ``pts``
    (either orientation, edges included)."""
    h, w = img.shape[:2]
    x0, y0 = np.floor(pts.min(0)).astype(int)
    x1, y1 = np.ceil(pts.max(0)).astype(int)
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    side = []
    for i in range(len(pts)):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % len(pts)]
        side.append((bx - ax) * (ys - ay) - (by - ay) * (xs - ax))
    side = np.stack(side)
    inside = (side >= 0).all(0) | (side <= 0).all(0)
    img[y0:y1 + 1, x0:x1 + 1][inside] = color


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='/tmp/fake_dota')
    p.add_argument('--split-out', default='/tmp/fake_dota_split/trainval')
    p.add_argument('--num-images', type=int, default=6)
    p.add_argument('--image-size', type=int, default=700)
    p.add_argument('--boxes-per-image', type=int, default=8)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    os.makedirs(f'{args.out}/images', exist_ok=True)
    os.makedirs(f'{args.out}/labelTxt', exist_ok=True)
    big = args.image_size
    for i in range(args.num_images):
        img = rng.randint(40, 90, (big, big, 3)).astype(np.uint8)
        lines = []
        for _ in range(args.boxes_per_image):
            cx = rng.uniform(60, big - 60)
            cy = rng.uniform(60, big - 60)
            w, h = rng.uniform(30, 90), rng.uniform(15, 45)
            a = rng.uniform(-math.pi, math.pi)
            pts = box_points(cx, cy, w, h, math.degrees(a))
            fill_convex(img, pts, rng.randint(120, 255, 3).astype(np.uint8))
            coords = ' '.join(f'{v:.1f}' for v in pts.reshape(-1))
            lines.append(f'{coords} {CLASSES[rng.randint(3)]} 0\n')
        imwrite(f'{args.out}/images/P{i:04d}.png', img)
        with open(f'{args.out}/labelTxt/P{i:04d}.txt', 'w') as f:
            f.writelines(lines)

    img_split.main(['--img-dirs', f'{args.out}/images',
                    '--ann-dirs', f'{args.out}/labelTxt',
                    '--sizes', '512', '--gaps', '128',
                    '--save-dir', args.split_out])


if __name__ == '__main__':
    main()
