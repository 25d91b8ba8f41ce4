"""Lloyd's assignment pass on the card (kernel `csrc/lloyd_assign.cu`).

`assign_labels` gives every point of every row of a padded k-means batch the
first index of its nearest centre among its row's first k, as (B, m) int64
labels, in one launch: the squared distance |a|^2 + |c|^2 - 2 a.c in the
arithmetic of XLA's CPU lowering (fused multiply-add chains, the clamp at 0)
and the first-index argmin, fused.  `assign_plain` is the plain version, the
pass `ops/cluster.py kmeans_rows` ran before the kernel: the same distances
as float64-emulated fused multiply-adds over chunks of points, and
`torch.argmin`.  It is the CPU's route and the oracle of the tests.

The kernel replaces no Pallas kernel: the JAX package's assignment is XLA's
(its `ops/cluster.py kmeans`).

The launch's shape follows the batch (`plan`): a block holds 1,024 points of
one row, or, where the rows give too few blocks to fill the card, 512, 256 or
128 points with its threads in 2, 4 or 8 groups, each over a share of the
centres.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS

_BIG = 3.4e38
_THREADS = 256     # threads a block (csrc kThreads)
_PIX = 4           # points a thread (csrc kPix)
_MAX_SPLIT = 8
_MIN_SHARE = 32    # centres a group at least takes of a full bucket
_WAVE_BLOCKS = 3   # blocks an SM that a launch aims to give the card


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, m: int, k_max: int, sms: int) -> tuple:
    """(split, blocks a row) of a launch over B rows of m points on a card
    of `sms` SMs: the fewest thread groups a block (1, 2, 4 or 8) that give
    the card `_WAVE_BLOCKS` blocks an SM, while each group keeps at least 32
    of a full bucket's centres."""
    split = 1
    while (split < _MAX_SPLIT and b * _ceil(m, _THREADS // split * _PIX) < _WAVE_BLOCKS * sms
           and k_max // (2 * split) >= _MIN_SHARE):
        split *= 2
    return split, _ceil(m, _THREADS // split * _PIX)


def _sq_dists(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, m, 3) x (B, k, 3) -> (B, m, k) squared distances, with the
    arithmetic of XLA's CPU lowering of ops/cluster._sq_dists: fused
    multiply-add chains for |c|^2 and a.c, then (|a|^2 + |c|^2) - 2 a.c."""
    a2 = fma32(a[..., 2], a[..., 2], fma32(a[..., 1], a[..., 1], a[..., 0] * a[..., 0]))
    c2 = fma32(c[..., 2], c[..., 2], fma32(c[..., 1], c[..., 1], c[..., 0] * c[..., 0]))
    a_ = a[:, :, None, :]
    c_ = c[:, None, :, :]
    ab = fma32(a_[..., 2], c_[..., 2], fma32(a_[..., 1], c_[..., 1], a_[..., 0] * c_[..., 0]))
    return torch.clamp((a2[:, :, None] + c2[:, None, :]) - 2.0 * ab, min=0.0)


def assign_plain(points: torch.Tensor, centers: torch.Tensor, k: torch.Tensor, k_max: int) -> torch.Tensor:
    """(B, m) int64 labels of the kernel, in plain PyTorch on the points'
    device: `_sq_dists` over chunks of points, centres j >= k[b] at 3.4e38,
    and `torch.argmin` (the first index of the minimum)."""
    b, m, _ = points.shape
    dev = points.device
    center_valid = torch.arange(k_max, device=dev)[None, :] < k[:, None]
    chunk = max(1, (1 << 23) // max(1, b * k_max))
    out = torch.empty((b, m), dtype=torch.int64, device=dev)
    for s in range(0, m, chunk):
        d2 = _sq_dists(points[:, s : s + chunk], centers)
        d2 = torch.where(center_valid[:, None, :], d2, torch.full((), _BIG, device=dev))
        out[:, s : s + chunk] = torch.argmin(d2, dim=2)
    return out


def assign_labels(points: torch.Tensor, centers: torch.Tensor, k: torch.Tensor, k_max: int) -> torch.Tensor:
    """(B, m) int64: for every point of every row, the first index of its
    nearest centre among centers[b, :k[b]] (0 in a row with no centre).

    points (B, m, 3) float32, the padding included (every point is
    assigned); centers (B, k_max, 3) float32; k (B,) int64.  All contiguous
    on one device.  On a CUDA device one launch on the current stream,
    recorded under (B, m, k_max); on the CPU the plain version
    (`assign_plain`).  Raises for anything else: it never falls back."""
    if not torch.is_tensor(points) or points.dim() != 3:
        raise ValueError("points must be a (B, m, 3) tensor")
    b, m = points.shape[:2]
    k_max = operator.index(k_max)
    if not (1 <= b <= 65535 and 1 <= m < 2**31 and 1 <= k_max and 3 * k_max < 2**31):
        raise ValueError(f"need 1 <= B <= 65535, 1 <= m < 2^31 and 1 <= k_max < 2^31 / 3, got {b}, {m}, {k_max}")
    _build.check_tensor("points", points, torch.float32, (b, m, 3))
    _build.check_tensor("centers", centers, torch.float32, (b, k_max, 3))
    _build.check_tensor("k", k, torch.int64, (b,))
    dev = points.device
    if any(t.device != dev for t in (centers, k)):
        raise ValueError(f"every tensor must be on points' device {dev}")
    if dev.type == "cpu":
        return assign_plain(points, centers, k, k_max)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    split, _ = plan(b, m, k_max, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, m), dtype=torch.int64, device=dev)
    _build.launch("lloyd_assign", "lloyd_assign_launch", dev, points.data_ptr(), centers.data_ptr(),
                  k.data_ptr(), out.data_ptr(), b, m, k_max, split, key=(b, m, k_max))
    if FLOPS.enabled():
        # 9 operations a pair of a point and a centre below its row's k (the
        # 3-deep dot product, the add of the norms, the doubling and
        # subtraction, the clamp, the compare and the select; the norms are
        # per point or per centre), the padded points included; bytes: the
        # points and the used centres read once, k read, the labels written.
        used = int(np.clip(k.cpu().numpy(), 0, k_max).sum())
        FLOPS.add(9.0 * m * used, 12.0 * b * m + 12.0 * used + 8.0 * b + 8.0 * b * m)
    return out
