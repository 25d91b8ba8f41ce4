"""Local Binary Patterns (uniform, P=8, R=1) on (B, H, W) float tensors.

skimage.feature.local_binary_pattern: 8 neighbors on the unit circle (4
axis-aligned, 4 bilinear-interpolated diagonals), thresholded >= center;
'uniform' maps patterns with <= 2 circular transitions to their popcount and
everything else to 9.  The diagonal interpolation reproduces XLA's float32
arithmetic (folded weight products, fused multiply-adds), so the codes on
flat areas, where a sample equals its center up to rounding, match the JAX
package bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from roibasedimagecompression_torch.ops.colors import fma32


def _neighbor_offsets(p: int = 8, r: float = 1.0) -> np.ndarray:
    i = np.arange(p)
    rr = -r * np.sin(2 * np.pi * i / p)
    cc = r * np.cos(2 * np.pi * i / p)
    rr = np.where(np.abs(rr - np.round(rr)) < 1e-8, np.round(rr), rr)
    cc = np.where(np.abs(cc - np.round(cc)) < 1e-8, np.round(cc), cc)
    return np.stack([rr, cc], axis=1)


def _shift(padded: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """Sample at (r+dy, c+dx) from the 1-px zero-padded image."""
    return padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def local_binary_pattern_uniform(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float -> (B, H, W) int32 uniform LBP codes in [0, 9]."""
    gray = gray.float()
    _, h, w = gray.shape
    padded = F.pad(gray, (1, 1, 1, 1))
    bits = []
    for dy, dx in _neighbor_offsets():
        fy, fx = int(np.floor(dy)), int(np.floor(dx))
        wy, wx = float(dy - fy), float(dx - fx)
        if wy == 0.0 and wx == 0.0:
            sample = _shift(padded, fy, fx, h, w)
        else:
            a, b = np.float32(1 - wy), np.float32(1 - wx)
            wy32, wx32 = np.float32(wy), np.float32(wx)
            s00 = _shift(padded, fy, fx, h, w)
            s01 = _shift(padded, fy, fx + 1, h, w)
            s10 = _shift(padded, fy + 1, fx, h, w)
            s11 = _shift(padded, fy + 1, fx + 1, h, w)
            sample = fma32(
                s11, float(wy32 * wx32),
                fma32(s10, float(wy32 * b), fma32(s00, float(a * b), s01 * float(a * wx32))),
            )
        bits.append(sample >= gray)
    b = torch.stack(bits, dim=0)
    transitions = torch.zeros(gray.shape, dtype=torch.int32, device=gray.device)
    for i in range(8):
        transitions += (b[i] != b[(i + 1) % 8]).int()
    popcount = b.int().sum(dim=0)
    return torch.where(transitions <= 2, popcount, torch.full_like(popcount, 9)).int()


def masked_histogram_density(
    values: torch.Tensor, mask: torch.Tensor, low: float, high: float, bins: int
) -> torch.Tensor:
    """Per row: np.histogram(values[mask], bins, range=(low, high),
    density=True) of (B, ...) values -> (B, bins) float32."""
    bsz = values.shape[0]
    v = values.reshape(bsz, -1).float()
    m = mask.reshape(bsz, -1)
    width = (high - low) / bins
    idx = torch.clamp(torch.floor((v - low) * float(np.float32(1.0 / width))), 0, bins - 1).long()
    in_range = (v >= low) & (v <= high) & m
    counts = torch.zeros(bsz, bins, dtype=torch.float32, device=v.device)
    counts.scatter_add_(1, idx, in_range.float())
    total = counts.sum(dim=1, keepdim=True)
    return counts / torch.clamp(total * width, min=1e-30)
