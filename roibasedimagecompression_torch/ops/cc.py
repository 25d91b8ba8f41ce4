"""Connected components of a boolean mask and per-component statistics, on
the host runtime and numpy.

The counterpart of the native branch of the JAX package's `ops/cc.py`.  Its
device propagation fallback, for a host without the runtime, is not ported
(ROADMAP A13): without the runtime this raises.  Everything here is integer
work or float64 means of the same values in the same order, so it is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from roibasedimagecompression_torch import native


def connected_components(mask: np.ndarray, connectivity: int = 8):
    """cv2.connectedComponents analogue: (labels (h, w) int32 with 0 the
    background and 1..n compact ids in raster order, n + 1)."""
    mask = np.asarray(mask) != 0
    if not mask.any():
        return np.zeros(mask.shape, np.int32), 1
    native.require("connected components")
    labels, n, _ = native.cc_label(mask, connectivity)
    return labels, n + 1


@dataclasses.dataclass
class ComponentStats:
    """Per-component stats, indexed by compact label (0 = background row)."""

    areas: np.ndarray  # (num,) int64
    bboxes: np.ndarray  # (num, 4) int32 (minr, minc, maxr, maxc), exclusive max

    def width(self):
        return self.bboxes[:, 3] - self.bboxes[:, 1]

    def height(self):
        return self.bboxes[:, 2] - self.bboxes[:, 0]


def component_stats(labels: np.ndarray, num_labels: int) -> ComponentStats:
    """Areas and bounding boxes per label (the runtime's one pass)."""
    native.require("component statistics")
    areas, bboxes = native.component_stats(labels, num_labels)
    return ComponentStats(areas=areas, bboxes=bboxes)


def label_means(labels: np.ndarray, values: np.ndarray, num_labels: int) -> np.ndarray:
    """float64 mean of `values` per label."""
    flat = labels.ravel()
    sums = np.bincount(flat, weights=values.ravel().astype(np.float64), minlength=num_labels)
    counts = np.bincount(flat, minlength=num_labels)
    out = np.zeros(num_labels, np.float64)
    nz = counts > 0
    out[nz] = sums[nz] / counts[nz]
    return out


def remove_labels(mask: np.ndarray, labels: np.ndarray, drop_ids: np.ndarray) -> np.ndarray:
    """A copy of `mask` with the pixels of the given label ids zeroed."""
    out = mask.copy()
    if len(drop_ids):
        out[np.isin(labels, drop_ids)] = 0
    return out
