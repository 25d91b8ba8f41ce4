"""Binary morphology of (H, W) bool maps: dilate, erode, open, close.

The counterpart of the JAX package's `ops/morphology.py`, which counts the
hits of a structuring element with a convolution and thresholds the count.
The count is an integer, so any order of adding it gives the same mask; here
the hit test is an OR (dilation) or AND (erosion) of the shifted map over the
element's cells, exact on every device.  Borders follow cv2's defaults: the
outside never dilates and never erodes.
"""

from __future__ import annotations

import numpy as np
import torch


def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k, k)), bit for bit."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            if r:
                dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            else:
                dx = c
            j1, j2 = max(c - dx, 0), min(c + dx + 1, ksize)
            out[i, j1:j2] = True
    return out


def rect_kernel(ksize: int) -> np.ndarray:
    return np.ones((ksize, ksize), bool)


def cross_kernel() -> np.ndarray:
    """scipy.ndimage's default structure (the connectivity-1 cross)."""
    k = np.zeros((3, 3), bool)
    k[1, :] = True
    k[:, 1] = True
    return k


def _hits(mask: torch.Tensor, se: np.ndarray, pad_value: bool, any_hit: bool) -> torch.Tensor:
    """OR (any_hit) or AND of the map shifted over the element's cells, as a
    correlation (the element is not mirrored), the outside `pad_value`."""
    se = np.asarray(se, bool)
    kh, kw = se.shape
    ph, pw = kh // 2, kw // 2
    h, w = mask.shape
    p = torch.full((h + kh - 1, w + kw - 1), bool(pad_value), dtype=torch.bool, device=mask.device)
    p[ph : ph + h, pw : pw + w] = mask
    out = torch.full((h, w), not any_hit, dtype=torch.bool, device=mask.device)
    for dy, dx in zip(*np.nonzero(se)):
        view = p[dy : dy + h, dx : dx + w]
        out = (out | view) if any_hit else (out & view)
    return out


def dilate(mask: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """Binary dilation; pixels outside the image never contribute."""
    out = mask.bool()
    for _ in range(iterations):
        out = _hits(out, se, False, True)
    return out


def erode(mask: torch.Tensor, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """Binary erosion; pixels outside the image count as foreground."""
    out = mask.bool()
    for _ in range(iterations):
        out = _hits(out, se, True, False)
    return out


def close(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return erode(dilate(mask, se), se)


def open_(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return dilate(erode(mask, se), se)


def binary_dilation_scipy(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with its default cross structure."""
    return dilate(mask, cross_kernel(), iterations=iterations)
