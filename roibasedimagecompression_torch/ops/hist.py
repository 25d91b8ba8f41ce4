"""Threshold statistics: masked percentile with linear interpolation, and
the masked mean.

The counterpart of the JAX package's `ops/hist.py masked_percentile` and
`masked_mean`.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32


def masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(values[mask], q) with linear interpolation, over the last
    axis of (..., N) tensors; 0 where a row's mask is empty.

    Masked-out entries sort to +inf and the interpolation index comes from
    the count of valid entries.  The interpolation is rounded as XLA's CPU
    code rounds it: sorted[hi] * frac is fused onto the rounded product
    sorted[lo] * (1 - frac), and q / 100 is a float32 constant.  Callers floor
    the result, so one ulp can move a threshold.
    """
    v = values.float()
    size = v.shape[-1]
    n = mask.sum(dim=-1, keepdim=True)
    sorted_v = torch.sort(torch.where(mask, v, torch.full_like(v, float("inf"))), dim=-1).values
    pos = (n.float() - 1.0) * float(np.float32(q / 100.0))
    lo = torch.clamp(torch.floor(pos).long(), 0, size - 1)
    hi = torch.clamp(torch.minimum(lo + 1, n - 1), 0, size - 1)
    frac = pos - lo.float()
    below = torch.gather(sorted_v, -1, lo)
    above = torch.gather(sorted_v, -1, hi)
    val = fma32(above, frac, below * (1.0 - frac))
    return torch.where(n > 0, val, torch.zeros_like(val)).squeeze(-1)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32 mean of `values` where `mask`, 0 where the mask is empty.

    Plain float32 sums, not XLA's order: its one caller (the ROI masks'
    density threshold, at most 0.01) compares it with box densities of edge
    pixels, which are at least 1/9, so its last bits cannot change a mask.
    """
    m = mask.reshape(-1).float()
    v = values.reshape(-1).float()
    return (v * m).sum() / torch.clamp(m.sum(), min=1.0)
