"""Rotated-box visualization on the host, without OpenCV.

The port of ``r3det_tpu/core/visualization.py``: ``imshow_det_rbboxes``
turns (cx, cy, w, h, theta[, score]) boxes into 4-corner contours drawn
on a BGR image with ``label|score`` captions. The contours equal
``cv2.drawContours``'s pixel for pixel (``core/draw.py``); the captions
are the port's own aliased font at cv2's anchor and colour, inside
cv2's text box.
"""
import numpy as np

from ..datasets.image_io import imread, imwrite
from .draw import draw_contours, put_text
from .rtransforms_np import obb2poly_np_v1

PALETTE = [(54, 67, 244), (99, 30, 233), (176, 39, 156), (183, 58, 103),
           (181, 81, 63), (243, 150, 33), (212, 188, 0), (136, 150, 0),
           (80, 175, 76), (74, 195, 139), (57, 220, 205), (59, 235, 255),
           (0, 152, 255), (34, 87, 255), (72, 85, 121), (180, 180, 180)]


def imshow_det_rbboxes(img, bboxes, labels, class_names=None,
                       score_thr=0.3, thickness=2, font_scale=0.5,
                       show=False, out_file=None):
    """Draw rotated detections, as the JAX package does.

    Args:
      img: PNG path (read as BGR) or BGR uint8 ndarray (drawn in place
        when it is contiguous).
      bboxes: (n, 5) or (n, 6) with a score column; only 6-column boxes
        are filtered by ``score_thr``, and 5-column boxes caption a score
        of 1.
      labels: (n,) int class ids.
      show: raises ``NotImplementedError``: the port has no window
        toolkit.
    """
    if show:
        raise NotImplementedError(
            'imshow_det_rbboxes(show=True): the port draws without a window '
            'toolkit; pass out_file instead')
    if isinstance(img, str):
        img = imread(img)
    img = np.ascontiguousarray(img)
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, bboxes.shape[-1])
    labels = np.asarray(labels).reshape(-1)
    if bboxes.shape[-1] == 6 and score_thr > 0:
        keep = bboxes[:, 5] >= score_thr
        bboxes = bboxes[keep]
        labels = labels[keep]
    if bboxes.shape[-1] == 5:
        bboxes = np.concatenate(
            [bboxes, np.ones((len(bboxes), 1), np.float32)], -1)
    polys = obb2poly_np_v1(bboxes)[:, :8].reshape(-1, 4, 2)
    for poly, box, label in zip(polys, bboxes, labels):
        color = PALETTE[int(label) % len(PALETTE)]
        draw_contours(img, [poly.astype(np.int32)], color, thickness)
        caption = class_names[int(label)] if class_names else str(int(label))
        caption += f'|{box[5]:.02f}'
        put_text(img, caption, (int(poly[0, 0]), int(poly[0, 1]) - 3),
                 font_scale, color)
    if out_file:
        imwrite(out_file, img)
    return img
