"""Adaptive Canny threshold selection on the host runtime.

The counterpart of the JAX package's `ops/canny.py` native path: the C++
runtime analyses the image and scores the 20 (low, high) candidates.
"""

from __future__ import annotations

import numpy as np

from roibasedimagecompression_torch import native


def _select_thresholds_native(image_rgb: np.ndarray):
    """(low, high): native analysis + native candidate scoring."""
    gray, mag, nms, cands = native.canny_analysis(image_rgb)
    best = native.score_candidates(gray, mag, nms, cands)
    return float(cands[best][0]), float(cands[best][1])


def select_thresholds_pair(image_rgb: np.ndarray):
    """Adaptive (low, high) Canny thresholds for one (h, w, 3) uint8 image."""
    return _select_thresholds_native(image_rgb)
