"""The benchmark's inputs: a fixed set of synthetic photographs, taken in an
order drawn from the run's seed.

`synthetic_image` is a frozen copy of the program's generator
(`utils/synthetic.py`): smooth gradients, flat discs and rectangles, a
textured patch and low-amplitude noise, the mix of flat areas, edges and
texture that the ROI stage, the split score and the palette clustering all
work on.  The set is fixed like the Kodak suite's 24 images; a seed changes
the order in which they arrive inside groups of 8, never which images, how
many or which group, so every seed offers the same work.
"""

from __future__ import annotations

import numpy as np

# Kodak's batch of 8: the size of the groups a seed permutes within.
GROUP = 8


def synthetic_image(seed: int, h: int = 128, w: int = 160) -> np.ndarray:
    """(h, w, 3) uint8 image, deterministic in `seed`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3), np.float64)
    for c in range(3):
        a, b, c0 = rng.uniform(-0.6, 0.6, 2).tolist() + [rng.uniform(40, 200)]
        img[..., c] = c0 + a * yy * 128 / h + b * xx * 128 / w
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
    r0, c0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
    patch = 30 * np.sin(yy[r0 : r0 + h // 3, c0 : c0 + w // 3] / 2.0) * np.cos(
        xx[r0 : r0 + h // 3, c0 : c0 + w // 3] / 3.0
    )
    img[r0 : r0 + h // 3, c0 : c0 + w // 3] += patch[..., None]
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def image_set(spec: dict) -> dict:
    """{image id: image} of a configuration's `images` entry."""
    return {int(s): synthetic_image(int(s), int(spec["height"]), int(spec["width"]))
            for s in spec["ids"]}


def arrival_order(ids, seed: int) -> list:
    """The set's ids in the order a run offers them: the set is cut into
    groups of `GROUP` consecutive ids, which come in id order; the seed
    permutes the ids inside each group.  Every seed gives the same groups
    in the same places, so a window that ends inside a cycle holds the
    same work whatever the seed."""
    rng = np.random.default_rng(int(seed))
    ids = [int(i) for i in ids]
    order = []
    for i in range(0, len(ids), GROUP):
        chunk = ids[i : i + GROUP]
        order.extend(chunk[j] for j in rng.permutation(len(chunk)))
    return order
