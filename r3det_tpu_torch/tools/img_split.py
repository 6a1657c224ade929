"""Offline DOTA patch splitter.

    python -m r3det_tpu_torch.tools.img_split --img-dirs DIR --ann-dirs DIR \
        --sizes 1024 --gaps 200 --save-dir OUT

Port of ``tools/split/img_split.py`` (the reference's BboxToolkit-derived
splitter) without OpenCV: sliding windows over large aerial images at one
or more scales, the window keep rule by in-image area rate, object-in-window
assignment by polygon IoF (an axis-aligned Sutherland-Hodgman clip),
crop + pad + per-patch annotation files. Images are read and written by
``datasets/image_io``. The arguments, the JSON config schema
(``tools/split/split_configs``) and the patch ids ``name__size__x___y``
(which ``DOTADataset.merge_det`` re-parses) are the JAX tool's.
"""
import argparse
import glob
import json
import os
import os.path as osp
import sys

import numpy as np

from ..datasets.image_io import imread, imwrite


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Split DOTA images into patches')
    p.add_argument('--base-json', default=None, help='JSON config file')
    p.add_argument('--img-dirs', nargs='+', default=None)
    p.add_argument('--ann-dirs', nargs='+', default=None)
    p.add_argument('--sizes', nargs='+', type=int, default=[1024])
    p.add_argument('--gaps', nargs='+', type=int, default=[200])
    p.add_argument('--rates', nargs='+', type=float, default=[1.0])
    p.add_argument('--img-rate-thr', type=float, default=0.6)
    p.add_argument('--iof-thr', type=float, default=0.7)
    p.add_argument('--no-padding', action='store_true')
    p.add_argument('--padding-value', nargs='+', type=float,
                   default=[104, 116, 124])
    p.add_argument('--save-dir', default=None)
    p.add_argument('--save-ext', default='.png')
    p.add_argument('--nproc', type=int, default=1,
                   help='worker processes (reference uses a Pool too)')
    args = p.parse_args(argv)
    if args.base_json:
        with open(args.base_json) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            k2 = k.replace('-', '_')
            if hasattr(args, k2) and v is not None:
                setattr(args, k2, v)
        if cfg.get('no_padding'):
            args.no_padding = True
    assert args.img_dirs and args.save_dir, 'need --img-dirs and --save-dir'
    return args


def sliding_windows(w, h, sizes, gaps, img_rate_thr):
    """Window proposals (x0, y0, x1, y1) with the reference keep rule:
    window kept if in-image area fraction > img_rate_thr; if no window at
    a (size, gap) passes, keep the best one (img_split.py:142-177)."""
    wins = []
    for size, gap in zip(sizes, gaps):
        step = size - gap
        x_num = 1 if w <= size else int(np.ceil((w - size) / step + 1))
        xs = [min(step * i, max(w - size, 0)) for i in range(x_num)]
        y_num = 1 if h <= size else int(np.ceil((h - size) / step + 1))
        ys = [min(step * i, max(h - size, 0)) for i in range(y_num)]
        cand, rates = [], []
        for y0 in ys:
            for x0 in xs:
                x1, y1 = x0 + size, y0 + size
                in_w = min(x1, w) - max(x0, 0)
                in_h = min(y1, h) - max(y0, 0)
                rate = max(in_w, 0) * max(in_h, 0) / (size * size)
                cand.append((x0, y0, x1, y1))
                rates.append(rate)
        rates = np.asarray(rates)
        keep = rates > img_rate_thr
        if not keep.any():
            keep[np.argmax(rates)] = True
        wins += [c for c, k in zip(cand, keep) if k]
    return wins


def poly_window_iof(polys, win):
    """IoF of each polygon vs an axis-aligned window: clipped-area / area."""
    x0, y0, x1, y1 = win
    out = np.zeros(len(polys))
    for i, p in enumerate(polys):
        pts = p.reshape(4, 2).astype(np.float64)
        area = abs(_shoelace(pts))
        if area < 1e-8:
            continue
        clipped = pts
        for axis, bound, keep_ge in ((0, x0, True), (0, x1, False),
                                     (1, y0, True), (1, y1, False)):
            clipped = _clip_axis(clipped, axis, bound, keep_ge)
            if len(clipped) < 3:
                break
        inter = abs(_shoelace(np.asarray(clipped))) if len(clipped) >= 3 \
            else 0.0
        out[i] = inter / area
    return out


def _shoelace(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def _clip_axis(pts, axis, bound, keep_ge):
    out = []
    n = len(pts)
    for i in range(n):
        cur, nxt = pts[i], pts[(i + 1) % n]
        c_in = (cur[axis] >= bound) == keep_ge
        n_in = (nxt[axis] >= bound) == keep_ge
        if c_in:
            out.append(cur)
        if c_in != n_in:
            t = (bound - cur[axis]) / (nxt[axis] - cur[axis] + 1e-12)
            out.append(cur + t * (nxt - cur))
    return np.asarray(out) if out else np.zeros((0, 2))


def load_dota_ann(ann_path):
    polys, classes, diffs = [], [], []
    if ann_path and osp.exists(ann_path):
        with open(ann_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 9:
                    continue
                try:
                    poly = np.array([float(v) for v in parts[:8]],
                                    np.float64)
                except ValueError:
                    continue
                polys.append(poly)
                classes.append(parts[8])
                diffs.append(int(parts[9]) if len(parts) >= 10 else 0)
    return (np.asarray(polys).reshape(-1, 8), classes,
            np.asarray(diffs, np.int64))


def split_one(img_path, ann_path, args, img_dir_out, ann_dir_out):
    img = imread(img_path)
    if img is None:
        print(f'skip unreadable {img_path}', file=sys.stderr)
        return 0
    name = osp.splitext(osp.basename(img_path))[0]
    polys, classes, diffs = load_dota_ann(ann_path)
    n_patches = 0
    # multi-scale = multiple WINDOW sizes over the original image (the
    # reference's scheme, img_split.py:430-432: size/rate, gap/rate); the
    # train/test pipeline's RResize normalizes patch sizes later, so merge
    # needs translation only.
    sizes = [int(s / r) for r in args.rates for s in args.sizes]
    gaps = [int(g / r) for r in args.rates for g in args.gaps]
    rpolys = polys
    h, w = img.shape[:2]
    for win in sliding_windows(w, h, sizes, gaps, args.img_rate_thr):
        x0, y0, x1, y1 = win
        size = x1 - x0
        patch = img[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)]
        if not args.no_padding and patch.shape[:2] != (size, size):
            padded = np.empty((size, size, 3), patch.dtype)
            padded[...] = np.asarray(args.padding_value)[None, None]
            padded[:patch.shape[0], :patch.shape[1]] = patch
            patch = padded
        pid = f'{name}__{size}__{x0}___{y0}'
        if len(rpolys):
            iofs = poly_window_iof(rpolys, win)
            sel = iofs >= args.iof_thr
            # truncated objects (partially inside) -> difficulty 2
            trunc = sel & (iofs < 1.0 - 1e-6)
        else:
            sel = np.zeros((0,), bool)
            trunc = sel
        # patches with no selected objects are still saved, with an empty
        # annotation file — reference behavior (img_split.py:289-292)
        lines = []
        for j in np.where(sel)[0]:
            shifted = rpolys[j].copy()
            shifted[0::2] -= x0
            shifted[1::2] -= y0
            diff = 2 if trunc[j] else int(diffs[j])
            coords = ' '.join(f'{v:.1f}' for v in shifted)
            lines.append(f'{coords} {classes[j]} {diff}\n')
        imwrite(osp.join(img_dir_out, pid + args.save_ext), patch)
        if ann_path is not None:
            with open(osp.join(ann_dir_out, pid + '.txt'), 'w') as f:
                f.writelines(lines)
        n_patches += 1
    return n_patches


def main(argv=None):
    args = parse_args(argv)
    img_out = osp.join(args.save_dir, 'images')
    ann_out = osp.join(args.save_dir, 'annfiles')
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(ann_out, exist_ok=True)
    ann_dirs = args.ann_dirs or [None] * len(args.img_dirs)
    jobs = []
    for img_dir, ann_dir in zip(args.img_dirs, ann_dirs):
        for img_path in sorted(glob.glob(osp.join(img_dir, '*.*'))):
            name = osp.splitext(osp.basename(img_path))[0]
            ann_path = osp.join(ann_dir, name + '.txt') if ann_dir else None
            jobs.append((img_path, ann_path))
    if args.nproc > 1:
        import functools
        import multiprocessing as mp
        work = functools.partial(_split_job, args=args, img_out=img_out,
                                 ann_out=ann_out)
        with mp.get_context('spawn').Pool(args.nproc) as pool:
            total = sum(pool.map(work, jobs))
    else:
        total = sum(split_one(ip, ap, args, img_out, ann_out)
                    for ip, ap in jobs)
    print(f'wrote {total} patches to {args.save_dir}')
    return total


def _split_job(job, args, img_out, ann_out):
    return split_one(job[0], job[1], args, img_out, ann_out)


if __name__ == '__main__':
    main()
