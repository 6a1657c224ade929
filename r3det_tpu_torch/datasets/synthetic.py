"""Seeded synthetic DOTA-like batches (numpy).

A copy of ``r3det_tpu/datasets/loader.py::SyntheticDetData``, not an
import: importing the JAX package pulls in jax. The same seed gives the
same batches as the JAX package's class: NHWC f32 images of unit normal
noise and, per image, 4 to min(max_gt, 32) rotated v1 boxes padded to
``max_gt`` with labels and a mask.
"""
import math

import numpy as np


class SyntheticDetData:
    """Infinite synthetic batches: ``batch()`` -> {'image': (B, S, S, 3)
    f32, 'gt_bboxes': (B, G, 5) f32, 'gt_labels': (B, G) int32,
    'gt_mask': (B, G) bool}, numpy arrays."""

    def __init__(self, batch_size=2, size=1024, max_gt=64, num_classes=15,
                 version='v1', seed=0):
        self.batch_size = batch_size
        self.size = size
        self.max_gt = max_gt
        self.num_classes = num_classes
        self.version = version
        self.rng = np.random.RandomState(seed)

    def batch(self):
        b, g, s = self.batch_size, self.max_gt, self.size
        images = self.rng.normal(0, 1, (b, s, s, 3)).astype(np.float32)
        boxes = np.zeros((b, g, 5), np.float32)
        labels = np.zeros((b, g), np.int32)
        mask = np.zeros((b, g), bool)
        for i in range(b):
            n = self.rng.randint(4, min(g, 32) + 1)
            boxes[i, :n] = np.stack([
                self.rng.uniform(50, s - 50, n),
                self.rng.uniform(50, s - 50, n),
                self.rng.uniform(16, 120, n),
                self.rng.uniform(12, 80, n),
                self.rng.uniform(-math.pi / 2 + 0.05, -0.05, n)], -1)
            labels[i, :n] = self.rng.randint(0, self.num_classes, n)
            mask[i, :n] = True
        return {'image': images, 'gt_bboxes': boxes, 'gt_labels': labels,
                'gt_mask': mask}

    def __iter__(self):
        while True:
            yield self.batch()
