"""Zhang-Suen skeletonization on the device.

The counterpart of the JAX package's `ops/thinning.py` (cv2.ximgproc.thinning
of the skeleton connection strategy): each sub-iteration is a pure stencil
over the 8-neighbourhood (neighbour count, 0 -> 1 transitions around the
ring, the direction conditions), written as shifted slices of a zero-padded
int32 map.  The loop runs to the fixpoint under the same iteration cap; it
checks for a change every few iterations (one host sync each), which reaches
the same fixpoint because the thinning only removes pixels, so a pass that
removes nothing leaves every later pass unchanged.
"""

from __future__ import annotations

import torch

# Iterations between two fixpoint checks: each check is a device-to-host sync.
_CHECK_EVERY = 4


def _neighbors(x: torch.Tensor) -> list:
    """P2..P9 clockwise from north (Zhang-Suen convention) of an (h, w) map."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))

    def s(dr, dc):
        return p[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]

    return [s(-1, 0), s(-1, 1), s(0, 1), s(1, 1), s(1, 0), s(1, -1), s(0, -1), s(-1, -1)]


def _subiter(x: torch.Tensor, first: bool) -> torch.Tensor:
    n = _neighbors(x)
    b = sum(n)
    ring = n + [n[0]]
    a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).int() for i in range(8))
    p2, p3, p4, p5, p6, p7, p8, p9 = n
    if first:
        c1 = (p2 * p4 * p6) == 0
        c2 = (p4 * p6 * p8) == 0
    else:
        c1 = (p2 * p4 * p8) == 0
        c2 = (p2 * p6 * p8) == 0
    remove = (x > 0) & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
    return torch.where(remove, torch.zeros_like(x), x)


def zhang_suen_thinning(mask: torch.Tensor, max_iters: int = 256) -> torch.Tensor:
    """Binary skeleton of an (h, w) bool map, on the map's device."""
    x = mask.to(torch.int32)
    done = 0
    while done < max_iters:
        before = x
        for _ in range(min(_CHECK_EVERY, max_iters - done)):
            x = _subiter(_subiter(x, True), False)
        done += min(_CHECK_EVERY, max_iters - done)
        if torch.equal(x, before):
            break
    return x > 0
