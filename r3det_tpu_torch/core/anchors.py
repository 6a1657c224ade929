"""Anchor generation for rotated detection (numpy).

Port of ``r3det_tpu/core/anchors.py::RAnchorGenerator`` (itself the
reference's ranchor_generator.py:7-39: mmdet's AnchorGenerator + xyxy ->
(cx, cy, w, h, 0)). A copy, not an import: importing the JAX package's
``core`` pulls in jax through ``r3det_tpu/core/__init__.py``.

Anchors for a fixed input size are constants, made once in numpy and moved
to the device by the detector.
"""
import math
from typing import List, Sequence, Tuple

import numpy as np


class RAnchorGenerator:
    """mmdet-compatible grid anchors, emitted as (cx, cy, w, h, theta=0).

    Matches mmdet's AnchorGenerator semantics (scale_major=True,
    center_offset=0): base sizes = strides; per-stride anchors enumerate
    ratios (major) x scales (minor) with w = s*scale/sqrt(ratio),
    h = s*scale*sqrt(ratio).
    """

    def __init__(self,
                 strides: Sequence[int],
                 ratios: Sequence[float] = (1.0, 0.5, 2.0),
                 scales: Sequence[float] = None,
                 octave_base_scale: int = None,
                 scales_per_octave: int = None,
                 center_offset: float = 0.0):
        self.strides = [int(s) for s in strides]
        self.ratios = np.asarray(ratios, dtype=np.float64)
        if scales is not None:
            self.scales = np.asarray(scales, dtype=np.float64)
        else:
            assert octave_base_scale is not None and scales_per_octave
            octs = np.array([2 ** (i / scales_per_octave)
                             for i in range(scales_per_octave)])
            self.scales = octave_base_scale * octs
        self.center_offset = center_offset
        self.base_anchors = [self._base_anchors(s) for s in self.strides]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _base_anchors(self, base_size: int) -> np.ndarray:
        """(A, 4) xyxy base anchors around (center_offset * stride)."""
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # scale-minor (mmdet scale_major=True layout): ratios x scales
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        cx = self.center_offset * base_size
        cy = self.center_offset * base_size
        return np.stack([cx - 0.5 * ws, cy - 0.5 * hs,
                         cx + 0.5 * ws, cy + 0.5 * hs], axis=-1)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     dtype=np.float32) -> List[np.ndarray]:
        """Per-level (H*W*A, 5) rotated anchors (theta = 0).

        Ordering is position-major, base-anchor-minor — the same layout a
        (B, H, W, A*5) head prediction reshapes into.
        """
        out = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride = self.strides[lvl]
            base = self.base_anchors[lvl]                  # (A, 4)
            sx = np.arange(w, dtype=np.float64) * stride
            sy = np.arange(h, dtype=np.float64) * stride
            shift = np.stack(np.meshgrid(sx, sy), axis=-1).reshape(-1, 2)
            xyxy = base[None, :, :] + np.tile(shift, 2)[:, None, :]
            xyxy = xyxy.reshape(-1, 4)
            cxy = (xyxy[:, :2] + xyxy[:, 2:]) / 2
            wh = xyxy[:, 2:] - xyxy[:, :2]
            theta = np.zeros((len(xyxy), 1))
            out.append(np.concatenate([cxy, wh, theta],
                                      axis=-1).astype(dtype))
        return out

    def valid_flags(self, featmap_sizes, pad_shape) -> List[np.ndarray]:
        """Per-level (H*W*A,) bool flags: anchor center cell inside the
        un-padded region. All-true for stride-aligned fixed-size inputs."""
        out = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride = self.strides[lvl]
            vh = min(int(math.ceil(pad_shape[0] / stride)), h)
            vw = min(int(math.ceil(pad_shape[1] / stride)), w)
            fy = np.zeros(h, bool)
            fx = np.zeros(w, bool)
            fy[:vh] = True
            fx[:vw] = True
            grid = (fy[:, None] & fx[None, :]).reshape(-1)
            out.append(np.repeat(grid, self.num_base_anchors[lvl]))
        return out
