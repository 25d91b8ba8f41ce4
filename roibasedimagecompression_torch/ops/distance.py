"""Euclidean distance transform by jump flooding.

The counterpart of the JAX package's `ops/distance.py`: the same step
schedule (the largest power of two >= max(h, w), halved down to 1), the same
neighbour order and the same strict `cand < best`, so ties resolve alike and
every pixel ends on the JAX package's seed.  Squared distances to a real seed
are integers below 2^24, exact in float32 however they are added.
"""

from __future__ import annotations

import torch

from roibasedimagecompression_torch.ops import colors as COL

_BIG = 1 << 20  # the seed coordinate of a pixel that has none yet
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def distance_transform_l2(foreground: torch.Tensor) -> torch.Tensor:
    """Distance (float32) from each foreground pixel of an (h, w) bool map to
    its jump-flood background seed; background pixels get 0."""
    h, w = foreground.shape
    dev = foreground.device
    fg = foreground.bool()
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    sy = torch.where(fg, big, yy)
    sx = torch.where(fg, big, xx)

    def d2(cy, cx):
        dy = (cy - yy).float()
        dx = (cx - xx).float()
        return dy * dy + dx * dx

    max_step, n_steps = 1, 1
    while max_step < max(h, w):
        max_step *= 2
        n_steps += 1
    pad = max_step
    for i in range(n_steps):
        k = max_step >> i
        py = torch.full((h + 2 * pad, w + 2 * pad), _BIG, dtype=torch.int32, device=dev)
        px = py.clone()
        py[pad : pad + h, pad : pad + w] = sy
        px[pad : pad + h, pad : pad + w] = sx
        best = d2(sy, sx)
        for dr_s, dc_s in _NEIGHBOURS:
            r0, c0 = pad + k * dr_s, pad + k * dc_s
            cy = py[r0 : r0 + h, c0 : c0 + w]
            cx = px[r0 : r0 + h, c0 : c0 + w]
            cand = d2(cy, cx)
            better = cand < best
            sy = torch.where(better, cy, sy)
            sx = torch.where(better, cx, sx)
            best = torch.where(better, cand, best)
    dist = COL.sqrt32(d2(sy, sx))
    return torch.where(fg, dist, torch.zeros((), device=dev))
