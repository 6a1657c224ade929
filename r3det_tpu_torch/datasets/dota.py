"""DOTA dataset: annotation loading, mAP evaluation, patch merge,
submission formatting.

Port of ``r3det_tpu/datasets/dota.py`` (itself the reference's
r3det/datasets/dota1.py):
- txt annotation parsing with poly->obb conversion + difficulty filter
  (one batched minimum-area-rectangle call a file);
- VOC-style mAP over float64 polygon IoU;
- cross-patch merge: translate patch detections back to source-image
  coordinates, per-class polygon NMS @ IoU 0.1;
- Task1 submission files + zip.

Host-side by design: it runs around the predict step. Images are read by
``image_io.imread`` (no OpenCV); polygon IoU and NMS run in the shared
C++ engine (``ops/polygon_geo``).
"""
import glob
import os
import os.path as osp
import re
import zipfile
from collections import defaultdict

import numpy as np

from ..core.rtransforms_np import obb2poly_np, polys2obbs_np
from ..ops.polygon_geo import polygon_iou, polygon_nms
from .image_io import imread


def _safe_default_nproc(cap):
    """Fork-pool default that degrades to serial once CUDA is live.

    os.fork() after CUDA initialization is unsafe (the child inherits a
    driver context it cannot use), and merge_det / evaluate run on the
    test CLI's path after the predict steps. Standalone offline evaluation
    keeps the pool. Callers can always pass nproc explicitly; results do
    not depend on it.
    """
    import torch
    if torch.cuda.is_initialized():
        return 1
    return max(1, min(os.cpu_count() or 1, cap))


DOTA10_CLASSES = ('plane', 'baseball-diamond', 'bridge', 'ground-track-field',
                  'small-vehicle', 'large-vehicle', 'ship', 'tennis-court',
                  'basketball-court', 'storage-tank', 'soccer-ball-field',
                  'roundabout', 'harbor', 'swimming-pool', 'helicopter')

DOTA15_CLASSES = DOTA10_CLASSES + ('container-crane',)

DOTA20_CLASSES = DOTA15_CLASSES + ('airport', 'helipad')


def _merge_one_image(dets, num_classes, version, nms_iou_thr):
    """Cross-patch per-class polygon NMS for one source image.

    dets: (n, 7) [cx, cy, w, h, theta, score, label] already translated
    to source-image coordinates.
    """
    per_cls_out = []
    for lbl in range(num_classes):
        cls_dets = dets[dets[:, 6] == lbl][:, :6]
        if len(cls_dets) == 0:
            per_cls_out.append(np.zeros((0, 6), np.float32))
            continue
        polys = obb2poly_np(cls_dets, version)     # (n, 9)
        keep = polygon_nms(polys, nms_iou_thr)
        per_cls_out.append(cls_dets[keep])
    return per_cls_out


class DOTADataset:
    """Iterable DOTA patch dataset over split-tool output.

    Directory layout (the split tool's output): ``ann_folder/*.txt`` with
    rows ``x0 y0 x1 y1 x2 y2 x3 y3 class difficulty`` and sibling image
    folder with ``<id>.png``.
    """

    CLASSES = DOTA10_CLASSES

    def __init__(self, ann_folder, img_folder=None, version='v1',
                 difficulty_thr=100, filter_empty=True, test_mode=False,
                 classes=None):
        self.ann_folder = ann_folder
        self.img_folder = img_folder or ann_folder.replace(
            'annfiles', 'images')
        self.version = version
        self.difficulty_thr = difficulty_thr
        self.test_mode = test_mode
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.cls2lbl = {c: i for i, c in enumerate(self.CLASSES)}
        self.data_infos = self._load_annotations()
        if filter_empty and not test_mode:
            self.data_infos = [d for d in self.data_infos
                               if len(d['ann']['bboxes'])]

    def __len__(self):
        return len(self.data_infos)

    def _load_annotations(self):
        """Parse ``ann_folder/*.txt`` (with the test-mode png glob when
        there is none)."""
        infos = []
        ann_files = sorted(glob.glob(osp.join(self.ann_folder, '*.txt')))
        if not ann_files:           # test mode: images without annotations
            for img in sorted(glob.glob(osp.join(self.img_folder, '*.png'))):
                img_id = osp.splitext(osp.basename(img))[0]
                infos.append(dict(
                    id=img_id, filename=osp.basename(img),
                    ann=dict(bboxes=np.zeros((0, 5), np.float32),
                             labels=np.zeros((0,), np.int64),
                             polygons=np.zeros((0, 8), np.float32))))
            return infos
        for ann_file in ann_files:
            img_id = osp.splitext(osp.basename(ann_file))[0]
            labels, polys = [], []
            with open(ann_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 9:
                        continue
                    poly = np.array(parts[:8], dtype=np.float32)
                    cls = parts[8]
                    diff = int(parts[9]) if len(parts) >= 10 else 0
                    if cls not in self.cls2lbl:
                        continue
                    if diff > self.difficulty_thr:
                        continue
                    labels.append(self.cls2lbl[cls])
                    polys.append(poly)
            obbs = polys2obbs_np(np.asarray(polys, np.float32),
                                 self.version)
            keep = [i for i, o in enumerate(obbs) if o is not None]
            infos.append(dict(
                id=img_id, filename=img_id + '.png',
                ann=dict(
                    bboxes=np.asarray([obbs[i] for i in keep],
                                      np.float32).reshape(-1, 5),
                    labels=np.asarray([labels[i] for i in keep], np.int64),
                    polygons=np.asarray([polys[i] for i in keep],
                                        np.float32).reshape(-1, 8))))
        return infos

    def get_sample(self, idx):
        """Raw sample dict for the pipeline (image read as BGR uint8)."""
        info = self.data_infos[idx]
        img = imread(osp.join(self.img_folder, info['filename']))
        if img is None:
            raise FileNotFoundError(osp.join(self.img_folder,
                                             info['filename']))
        return dict(img=img, img_shape=img.shape,
                    gt_bboxes=info['ann']['bboxes'].copy(),
                    gt_labels=info['ann']['labels'].copy(),
                    img_id=info['id'])

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def evaluate(self, results, iou_thr=0.5, use_07_metric=False,
                 logger=print, nproc=None):
        """results: list (per image) of per-class (n, 6) det arrays.

        Returns dict with mAP + per-class AP. AP interpolation defaults to
        'area' mode (the reference's eval_map computes area AP for every
        dataset but voc07); 11-point is an opt-in (use_07_metric=True).
        """
        annotations = [d['ann'] for d in self.data_infos]
        mean_ap, per_cls = eval_rbbox_map(
            results, annotations, iou_thr=iou_thr, version=self.version,
            use_07_metric=use_07_metric, class_names=self.CLASSES,
            logger=logger, nproc=nproc)
        out = {'mAP': mean_ap}
        out.update({f'AP_{c}': ap for c, ap in per_cls.items()})
        return out

    # ------------------------------------------------------------------
    # Patch merge + submission
    # ------------------------------------------------------------------

    _PATCH_RE = re.compile(r'^(.*?)__\d+__(\d+)___(\d+)$')

    def merge_det(self, results, nms_iou_thr=0.1, nproc=None):
        """Merge patch detections back to full images.

        Patch ids look like ``P0006__1024__0___2048`` (name, window size,
        x, y). Boxes are translated by (x, y) — window size needs no undo
        because test-time RResize rescaling already restored original-image
        coordinates — and deduped per class with polygon NMS @
        ``nms_iou_thr``. ``nproc`` fans the per-image merges over a fork
        Pool (serial when cpu_count is 1 or CUDA is live).
        Returns (ids, per-image per-class det lists).
        """
        collector = defaultdict(list)
        for info, per_cls in zip(self.data_infos, results):
            m = self._PATCH_RE.match(info['id'])
            if m:
                name, x, y = m.group(1), float(m.group(2)), float(m.group(3))
            else:
                name, x, y = info['id'], 0.0, 0.0
            for lbl, dets in enumerate(per_cls):
                if len(dets) == 0:
                    continue
                d = dets.copy()
                d[:, 0] = d[:, 0] + x
                d[:, 1] = d[:, 1] + y
                labelled = np.concatenate(
                    [d, np.full((len(d), 1), lbl, np.float32)], -1)
                collector[name].append(labelled)

        ids = list(collector.keys())
        num_classes = len(self.CLASSES)
        args = [(np.concatenate(collector[name], 0), num_classes,
                 self.version, nms_iou_thr) for name in ids]
        if nproc is None:
            nproc = _safe_default_nproc(8)
        if nproc > 1 and len(args) > 1:
            import multiprocessing as mp
            with mp.get_context('fork').Pool(nproc) as pool:
                merged = pool.starmap(_merge_one_image, args)
        else:
            merged = [_merge_one_image(*a) for a in args]
        return ids, merged

    def format_results(self, results, out_dir, nms_iou_thr=0.1):
        """Write Task1_<cls>.txt files + zip."""
        os.makedirs(out_dir, exist_ok=True)
        ids, merged = self.merge_det(results, nms_iou_thr)
        files = {}
        for cls in self.CLASSES:
            files[cls] = open(osp.join(out_dir, f'Task1_{cls}.txt'), 'w')
        try:
            for img_id, per_cls in zip(ids, merged):
                for lbl, dets in enumerate(per_cls):
                    if len(dets) == 0:
                        continue
                    polys = obb2poly_np(dets, self.version)
                    for p in polys:
                        coords = ' '.join(f'{v:.2f}' for v in p[:8])
                        files[self.CLASSES[lbl]].write(
                            f'{img_id} {p[8]:.4f} {coords}\n')
        finally:
            for f in files.values():
                f.close()
        zip_path = osp.join(out_dir, 'submission.zip')
        with zipfile.ZipFile(zip_path, 'w', zipfile.ZIP_DEFLATED) as z:
            for cls in self.CLASSES:
                z.write(osp.join(out_dir, f'Task1_{cls}.txt'),
                        f'Task1_{cls}.txt')
        return zip_path


# ----------------------------------------------------------------------
# mAP evaluation (polygon IoU, float64, host)
# ----------------------------------------------------------------------

def _average_precision(recall, precision, use_07_metric=False):
    """VOC AP. area mode by default (mmdet 'area'); 11-point optional."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _tpfp_single(det_polys, gt_polys, iou_thr):
    """Greedy TP/FP matching for one image & class.

    Precondition: det_polys already sorted score-descending (the caller
    sorts once). No difficulty split: the loader already filtered by
    difficulty.
    """
    nd = len(det_polys)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if nd == 0:
        return tp, fp
    if len(gt_polys) == 0:
        fp[:] = 1
        return tp, fp
    ious = polygon_iou(det_polys, gt_polys)
    matched = np.zeros(len(gt_polys), bool)
    for i in range(nd):
        j = int(np.argmax(ious[i]))
        if ious[i, j] >= iou_thr and not matched[j]:
            matched[j] = True
            tp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def _class_ap(c, results, annotations, iou_thr, version, use_07_metric):
    """AP of one class over all images. Returns (ap, counted) where
    counted=False means the class has no gt (excluded from the mean,
    matching dota1.py eval_map's num_gts gate)."""
    all_scores, all_tp, all_fp = [], [], []
    num_gts = 0
    for res, ann in zip(results, annotations):
        dets = res[c]
        gt_sel = ann['labels'] == c
        if 'polygons' in ann and len(ann['polygons']):
            gt_polys = ann['polygons'][gt_sel]
        else:
            gtb = ann['bboxes'][gt_sel]
            gt_polys = obb2poly_np(
                np.concatenate([gtb, np.zeros((len(gtb), 1),
                                              np.float32)], -1),
                version)[:, :8] if len(gtb) else np.zeros((0, 8))
        num_gts += len(gt_polys)
        if len(dets) == 0:
            continue
        det_polys = obb2poly_np(dets, version)[:, :8]
        scores = dets[:, 5]
        order = np.argsort(-scores, kind='stable')
        tp, fp = _tpfp_single(det_polys[order], gt_polys, iou_thr)
        all_scores.append(scores[order])
        all_tp.append(tp)
        all_fp.append(fp)
    if num_gts == 0:
        return 0.0, False
    if not all_scores:
        return 0.0, True
    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp)
    fp = np.concatenate(all_fp)
    order = np.argsort(-scores, kind='stable')
    tp = np.cumsum(tp[order])
    fp = np.cumsum(fp[order])
    recall = tp / max(num_gts, 1)
    precision = tp / np.maximum(tp + fp, 1e-12)
    return _average_precision(recall, precision, use_07_metric), True


def eval_rbbox_map(results, annotations, iou_thr=0.5, version='v1',
                   use_07_metric=False, class_names=DOTA10_CLASSES,
                   logger=print, nproc=None):
    """DOTA mAP. results[i][c] = (n, 6) dets; annotations[i] has
    'bboxes'/'labels'/'polygons'. Defaults to 'area' AP like the
    reference; use_07_metric=True opts into 11-point interpolation.

    nproc: per-class TP/FP matching fans out over a fork Pool. Defaults to
    min(cpu_count, num_classes), serial once CUDA is live in this process
    (a fork after CUDA init is unsafe).
    """
    num_classes = len(class_names)
    if nproc is None:
        nproc = _safe_default_nproc(num_classes)
    args = [(c, results, annotations, iou_thr, version, use_07_metric)
            for c in range(num_classes)]
    if nproc > 1:
        import multiprocessing as mp
        with mp.get_context('fork').Pool(nproc) as pool:
            outs = pool.starmap(_class_ap, args)
    else:
        outs = [_class_ap(*a) for a in args]
    per_class_ap = {class_names[c]: ap for c, (ap, _) in enumerate(outs)}
    aps = [ap for ap, counted in outs if counted]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    if logger:
        width = max(len(c) for c in class_names)
        for c, ap in per_class_ap.items():
            logger(f'{c:<{width}}  AP {ap:.4f}')
        logger(f'{"mAP":<{width}}  {mean_ap:.4f}')
    return mean_ap, per_class_ap


class DOTA15Dataset(DOTADataset):
    """DOTA-v1.5 (adds container-crane)."""
    CLASSES = DOTA15_CLASSES


class DOTA20Dataset(DOTADataset):
    """DOTA-v2.0 (adds airport, helipad)."""
    CLASSES = DOTA20_CLASSES
