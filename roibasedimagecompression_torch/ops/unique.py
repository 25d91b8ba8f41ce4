"""Exact palettes: the unique colours of a pixel list and each pixel's index.

The counterpart of the JAX package's `ops/unique.py unique_colors` on its
host path (the native radix sort-unique).
"""

from __future__ import annotations

import numpy as np

from roibasedimagecompression_torch import native


def unique_colors(pixels: np.ndarray):
    """(palette (m, 3) uint8 sorted by packed value r << 16 | g << 8 | b, the
    order of np.unique(pixels, axis=0); indices (n,) int32) for (n, 3) uint8
    pixels."""
    pixels = np.asarray(pixels, dtype=np.uint8).reshape(-1, 3)
    if pixels.shape[0] == 0:
        return np.zeros((0, 3), np.uint8), np.zeros(0, np.int32)
    packed = (
        (pixels[:, 0].astype(np.int64) << 16)
        | (pixels[:, 1].astype(np.int64) << 8)
        | pixels[:, 2].astype(np.int64)
    )
    uniq, inverse = native.unique_inverse_i64(packed)
    palette = np.stack([(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1)
    return palette.astype(np.uint8), inverse.astype(np.int32)
