"""Filters over the two spatial axes of (B, H, W[, C]) tensors.

Written as reflect padding plus shifted adds in a fixed order, so the CPU
and the card sum the taps in the same order (a cuDNN convolution would pick
its own order, and TF32 unless disabled).  `reflect` is numpy's mode of that
name (mirror without repeating the edge, cv2's BORDER_REFLECT_101).

`box_density` adds its k*k taps in the order of the JAX package's CPU
convolution, read from XLA's CPU run (Eigen's contraction of the image
patches): see `ops/xla_order.py`.  The gap-bridging reach
maps (`conv2d_same_multi`) are only ever tested > 0, so they are computed
exactly as hit tests.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import xla_order as XO


def _reflect_index(n: int, before: int, after: int) -> np.ndarray:
    """Source index of every position of an axis of n, reflect-padded by
    (before, after): numpy's mode, repeated reflections included."""
    i = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(i)
    m = np.mod(i, 2 * (n - 1))
    return np.where(m >= n, 2 * (n - 1) - m, m)


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Reflect-pad one axis (axis 1 = rows, 2 = cols of a (B, H, W, ...) tensor)."""
    idx = _reflect_index(x.shape[axis], before, after)
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
    """skimage.filters.sobel edge magnitude: kernels /4, magnitude /sqrt(2).

    In the jitted split score, its only caller, XLA fuses h*h into the sum
    and multiplies by float32(1/sqrt(2)) in place of the division."""
    h = _sep3(img, (-0.25, 0.0, 0.25), (1.0, 2.0, 1.0))
    v = _sep3(img, (0.25, 0.5, 0.25), (-1.0, 0.0, 1.0))
    return COL.sqrt32(COL.fma32(h, h, v * v)) * float(np.float32(1.0 / np.sqrt(2.0)))


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


def _reflect_pad2(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """An (H, W) map reflect-padded for a SAME-size (kh, kw) correlation."""
    ph, pw = kh // 2, kw // 2
    return _pad_axis(_pad_axis(x[None], 1, ph, kh - 1 - ph), 2, pw, kw - 1 - pw)[0]


def conv2d_same(x: torch.Tensor, kernel) -> torch.Tensor:
    """Single-channel 2-D correlation of an (H, W) map, SAME size, reflect
    borders (cv2's BORDER_REFLECT_101), its taps added in the order of XLA's
    CPU convolution.  XLA fuses each product into its addition; here
    products are rounded first, so the bits are XLA's wherever the products
    are exact (0/1 maps, as `box_density`'s)."""
    kern = np.asarray(kernel, np.float32)
    kh, kw = kern.shape
    x = x.float()
    h, w = x.shape
    p = _reflect_pad2(x, kh, kw)
    flat = kern.reshape(-1)
    uniform = bool((flat == flat[0]).all())
    if uniform:
        p = p * float(flat[0])

    def tap(t):
        dy, dx = divmod(t, kw)
        v = p[dy : dy + h, dx : dx + w]
        return v if uniform else v * float(flat[t])

    n_taps = kh * kw
    if n_taps // XO.SHARDS > 32:
        return XO.eigen_k_shards(tap, n_taps, h * w)
    return XO.eigen_lanes(tap, range(n_taps))


def box_density(binary: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Local density of non-zero pixels of an (H, W) map: the mean over a
    k x k window, reflect borders (cv2.filter2D with ones(k, k) / k^2); the
    input is scaled to [0, 1] when its maximum exceeds 1.  For 0/1 maps (the
    codec's only ones) the float32 sums are the JAX package's CPU bits."""
    x = binary.float()
    if x.numel() and bool(x.max() > 1.0):
        x = COL.div32(x, 255.0)
    k = int(kernel_size)
    weight = np.float32(1.0) / np.float32(k * k)
    return conv2d_same(x, np.full((k, k), weight, np.float32))


def conv2d_same_multi(x: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """Where each of N same-size correlations of an (H, W) map with
    non-negative (kh, kw) kernels is positive: (N, H, W) bool, SAME size,
    reflect borders.  The gap-bridging stage reads its reach maps only as
    `> 0`, and with non-negative inputs and weights a sum is positive exactly
    when one product is, so this tests hits (OR of the shifted map over each
    kernel's non-zero taps) and is exact on every device."""
    kernels = np.asarray(kernels)
    n, kh, kw = kernels.shape
    p = _reflect_pad2(x > 0, kh, kw)
    h, w = x.shape
    out = torch.zeros((n, h, w), dtype=torch.bool, device=x.device)
    for i in range(n):
        for dy, dx in zip(*np.nonzero(kernels[i] > 0)):
            out[i] |= p[dy : dy + h, dx : dx + w]
    return out


def directional_reach_kernels(max_gap: int, local_window: int) -> np.ndarray:
    """The 8 gap-bridging kernels (4 opposite-direction pairs): each marks
    the cells 1..max_gap along one direction inside a (2 * local_window +
    1)^2 window, normalized to sum 1.  (8, k, k) float32 in pair order [lr0,
    lr1, ud0, ud1, d0, d1, a0, a1]."""
    size = local_window * 2 + 1
    dirs = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, 1), (-1, 1), (1, -1)]
    kernels = np.zeros((8, size, size), np.float32)
    c = local_window
    for i, (dx, dy) in enumerate(dirs):
        for d in range(1, max_gap + 1):
            x, y = c + dx * d, c + dy * d
            if 0 <= x < size and 0 <= y < size:
                kernels[i, y, x] = 1.0
        s = kernels[i].sum()
        if s > 0:
            kernels[i] /= s
    return kernels
