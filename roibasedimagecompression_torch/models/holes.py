"""Black-hole filling: small black connected regions take their neighbours'
most common colour.

The counterpart of the JAX package's `models/holes.py`: an off-by-default
switch (CodecConfig.fill_black_holes > 0) applied to the tier-2 colour map
before tier-3 clustering.  Host numpy, as there: it runs on at most a few
thousand hole pixels.
"""

from __future__ import annotations

import numpy as np

from roibasedimagecompression_torch.ops import cc as CC


def _pack(colors_rgb: np.ndarray) -> np.ndarray:
    return (
        (colors_rgb[..., 0].astype(np.int64) << 16)
        | (colors_rgb[..., 1].astype(np.int64) << 8)
        | colors_rgb[..., 2].astype(np.int64)
    )


def fill_black_holes(colors_rgb: np.ndarray, max_hole_size: int = 10, device=None) -> np.ndarray:
    """Fill black 8-connected regions of size <= max_hole_size.

    Each hole is filled with the most common non-black color among its
    dilated neighbor ring (each neighbor PIXEL counted once, matching the
    reference's `dilated & ~region` mask); holes whose ring is all black stay
    black.  Returns a new (h, w, 3) uint8 array.  `device` runs the
    components without the native runtime (the CPU when None).
    """
    packed = _pack(colors_rgb)
    black = packed == 0
    if not black.any():
        return colors_rgb
    h, w = black.shape
    labels, num = CC.connected_components(black, connectivity=8, device=device)
    if num <= 1:
        return colors_rgb
    sizes = np.bincount(labels.ravel(), minlength=num)
    small = (sizes > 0) & (sizes <= max_hole_size)
    small[0] = False
    if not small.any():
        return colors_rgb

    # (hole label, neighbor flat index) adjacency pairs over the 8-stencil,
    # deduplicated so each ring pixel votes once per hole.
    flat_idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    pair_keys = []
    small_mask = small[labels]
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            src = small_mask[
                max(0, -dr) : h - max(0, dr), max(0, -dc) : w - max(0, dc)
            ]
            lab = labels[
                max(0, -dr) : h - max(0, dr), max(0, -dc) : w - max(0, dc)
            ]
            nb_black = black[
                max(0, dr) : h + min(0, dr), max(0, dc) : w + min(0, dc)
            ]
            nb_idx = flat_idx[
                max(0, dr) : h + min(0, dr), max(0, dc) : w + min(0, dc)
            ]
            sel = src & ~nb_black
            if sel.any():
                pair_keys.append(
                    lab[sel].astype(np.int64) * (h * w) + nb_idx[sel]
                )
    if not pair_keys:
        return colors_rgb
    uniq_pairs = np.unique(np.concatenate(pair_keys))
    pair_label = uniq_pairs // (h * w)
    pair_color = packed.ravel()[uniq_pairs % (h * w)]

    # Most common ring color per hole; ties break to the smaller packed color
    # (deterministic; the reference's Counter tie-break is insertion order).
    ck, counts = np.unique(
        pair_label * (1 << 24) + pair_color, return_counts=True
    )
    lab = ck >> 24
    col = ck & 0xFFFFFF
    order = np.lexsort((col, -counts, lab))
    lab_o = lab[order]
    first = np.ones(len(lab_o), bool)
    first[1:] = lab_o[1:] != lab_o[:-1]
    fill = np.full(num, -1, np.int64)
    fill[lab_o[first]] = col[order][first]

    fillable = small_mask & (fill[labels] >= 0)
    out = colors_rgb.copy()
    filled = fill[labels[fillable]]
    out[fillable] = np.stack(
        [(filled >> 16) & 0xFF, (filled >> 8) & 0xFF, filled & 0xFF], axis=1
    ).astype(np.uint8)
    return out
