"""Exact palettes: the unique colours of a pixel list and each pixel's index.

The counterpart of the JAX package's `ops/unique.py unique_colors`: the
native radix sort-unique on the host, or without the runtime the device
sort-unique (`unique_packed_padded`) on the caller's device.  Both give
np.unique's sorted palette and inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.utils import device as DEV

_PAD_VALUE = 2**31 - 1


def unique_packed_padded(packed: torch.Tensor, capacity: int):
    """Unique values of a flat int32 tensor, padded to `capacity`: (values
    (capacity,) sorted, slots >= count hold 2^31 - 1; count; inverse).  With
    more than `capacity` unique values the first `capacity` are kept, and
    `count` and `inverse` still count them all, as the JAX function's
    dropping scatter does."""
    n = packed.shape[0]
    sorted_vals, order = torch.sort(packed, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=packed.device)
    is_first[1:] = sorted_vals[1:] != sorted_vals[:-1]
    rank = torch.cumsum(is_first.to(torch.int64), 0) - 1
    count = int(rank[-1]) + 1 if n else 0
    values = torch.full((capacity,), _PAD_VALUE, dtype=packed.dtype, device=packed.device)
    if count > capacity:
        fits = rank < capacity
        values[rank[fits]] = sorted_vals[fits]
    else:
        values[rank] = sorted_vals
    inverse = torch.empty(n, dtype=torch.int64, device=packed.device)
    inverse[order] = rank
    return values, count, inverse


def unique_colors(pixels: np.ndarray, device=None):
    """(palette (m, 3) uint8 sorted by packed value r << 16 | g << 8 | b, the
    order of np.unique(pixels, axis=0); indices (n,) int32) for (n, 3) uint8
    pixels.  `device` runs the sort without the runtime (the CPU when None)."""
    pixels = np.asarray(pixels, dtype=np.uint8).reshape(-1, 3)
    n = pixels.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.uint8), np.zeros(0, np.int32)
    packed = (
        (pixels[:, 0].astype(np.int64) << 16)
        | (pixels[:, 1].astype(np.int64) << 8)
        | pixels[:, 2].astype(np.int64)
    )
    if native.available():
        uniq, inverse = native.unique_inverse_i64(packed)
    else:
        values, count, inverse = unique_packed_padded(
            torch.from_numpy(packed.astype(np.int32)).to(DEV.or_cpu(device)), n)
        uniq, inverse = values[:count].cpu().numpy().astype(np.int64), inverse.cpu().numpy()
    palette = np.stack([(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1)
    return palette.astype(np.uint8), inverse.astype(np.int32)
