"""Synthetic RGB test images made from a seed.

Smooth gradients, flat discs and rectangles, and low-amplitude noise: the
mix of flat areas, edges and texture that the ROI stage, the split score and
the palette clustering all have work to do on.  (Uniform noise would make
every pixel its own color and every pixel ROI.)
"""

from __future__ import annotations

import numpy as np


def synthetic_image(seed: int, h: int = 128, w: int = 160) -> np.ndarray:
    """(h, w, 3) uint8 image, deterministic in `seed`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3), np.float64)
    # Background: a two-axis gradient per channel.
    for c in range(3):
        a, b, c0 = rng.uniform(-0.6, 0.6, 2).tolist() + [rng.uniform(40, 200)]
        img[..., c] = c0 + a * yy * 128 / h + b * xx * 128 / w
    # Flat rectangles and discs.
    for _ in range(int(rng.integers(3, 7))):
        color = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            r0, c0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            r1 = min(h, r0 + int(rng.integers(8, max(9, h // 2))))
            c1 = min(w, c0 + int(rng.integers(8, max(9, w // 2))))
            img[r0:r1, c0:c1] = color
        else:
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            rad = rng.uniform(min(h, w) / 12, min(h, w) / 4)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad] = color
    # A textured patch (sinusoid) and low-amplitude noise everywhere.
    r0, c0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
    patch = 30 * np.sin(yy[r0 : r0 + h // 3, c0 : c0 + w // 3] / 2.0) * np.cos(
        xx[r0 : r0 + h // 3, c0 : c0 + w // 3] / 3.0
    )
    img[r0 : r0 + h // 3, c0 : c0 + w // 3] += patch[..., None]
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)
