"""Separable filters over the two spatial axes of (B, H, W[, C]) tensors.

Written as reflect padding plus shifted adds in a fixed order, so the CPU
and the card sum the taps in the same order (a cuDNN convolution would pick
its own order, and TF32 unless disabled).  `reflect` is numpy's mode of that
name (mirror without repeating the edge, cv2's BORDER_REFLECT_101).
"""

from __future__ import annotations

import numpy as np
import torch


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Reflect-pad one axis (axis 1 = rows, 2 = cols of a (B, H, W, ...) tensor)."""
    n = x.shape[axis]
    idx = list(range(before, 0, -1)) + list(range(n)) + list(range(n - 2, n - 2 - after, -1))
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def _taps(x: torch.Tensor, axis: int, weights) -> torch.Tensor:
    """Correlation with `weights` along `axis`, reflect borders, same size."""
    k = len(weights)
    r = k // 2
    p = _pad_axis(x, axis, r, k - 1 - r)
    n = x.shape[axis]
    acc = None
    for t, wt in enumerate(weights):
        term = p.narrow(axis, t, n) * float(wt)
        acc = term if acc is None else acc + term
    return acc


def _sep3(img: torch.Tensor, vker, hker) -> torch.Tensor:
    """Separable 3-tap correlation over (B, H, W), reflect-101 borders."""
    x = img.float()
    return _taps(_taps(x, 1, vker), 2, hker)


def sobel_cv2(gray: torch.Tensor) -> tuple:
    """cv2.Sobel(gray, CV_64F, 1, 0 / 0, 1, ksize=3) pair (gx, gy) of a
    (B, H, W) tensor, BORDER_REFLECT_101."""
    gx = _sep3(gray, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    gy = _sep3(gray, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
    return gx, gy


def sobel_skimage(img: torch.Tensor) -> torch.Tensor:
    """skimage.filters.sobel edge magnitude: kernels /4, magnitude /sqrt(2)."""
    h = _sep3(img, (-0.25, 0.0, 0.25), (1.0, 2.0, 1.0))
    v = _sep3(img, (0.25, 0.5, 0.25), (-1.0, 0.0, 1.0))
    return torch.sqrt(h * h + v * v) / float(np.sqrt(2.0))


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _taps9_xla(x: torch.Tensor, axis: int, weights) -> torch.Tensor:
    """A 9-tap correlation along `axis` (reflect borders, same size) added as
    XLA's CPU convolution adds it: products rounded, then ((t0 + t1) + (t4 +
    t5)) + ((t2 + t3) + (t6 + t7)), then + t8."""
    n = x.shape[axis]
    p = _pad_axis(x, axis, 4, 4)
    t = [p.narrow(axis, i, n) * float(w) for i, w in enumerate(weights)]
    return (((t[0] + t[1]) + (t[4] + t[5])) + ((t[2] + t[3]) + (t[6] + t[7]))) + t[8]


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a (B, H, W, C) tensor over H and W
    (scipy.ndimage.gaussian_filter semantics, reflect borders).  The 9-tap
    kernel of sigma 1 (SLIC's) sums its taps in the JAX package's order, bit
    for bit; other kernels in tap order."""
    x = img.float()
    if sigma <= 0:
        return x
    k = [float(v) for v in gaussian_kernel1d(sigma)]
    taps = _taps9_xla if len(k) == 9 else _taps
    return taps(taps(x, 1, k), 2, k)

