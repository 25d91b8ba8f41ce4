"""k-means++ initial centres on the card (kernel `csrc/kmeanspp.cu`).

`kmeanspp_centers` computes the (B, k_max, 3) float32 centres of
`ops/cluster.py _plusplus_loop`, its plain version, bit for bit, in one
launch for every row and every step: the same noise table (kernel 3,
`ops/cuda/gumbel.py`), the same float32 log table of squared distances
(`ops/cluster.py _log32_table`), integer colours in [0, 255], so every
squared distance is exact and the one rounding is the add of the noise and
the logit.  Unweighted seeding only: the weighted form computes its
logarithm and stays the plain loop.

The launch's shape follows the row's width (`plan`): one block a row up to
4,096 points, else a thread-block cluster of up to 16 blocks a row, each
block keeping its slice of the row in shared memory (in a global scratch
buffer beyond 10,240 points a block).
"""

from __future__ import annotations

import operator

import torch

from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS

_NARROW = 4096     # points a row up to which one block seeds it
_ON_CHIP = 10_240  # points a block keeps in shared memory (5 floats each, 200 KiB; csrc kOnChip)
_MAX_CLUSTER = 16  # H100's largest (non-portable) cluster


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int) -> tuple:
    """(cluster, threads, slice, on_chip) of a launch over rows of m points:
    blocks a row, threads a block (four points a thread on narrow rows),
    points a block, and whether a block's slice fits its shared memory."""
    if m <= _NARROW:
        return 1, max(32, _ceil(_ceil(m, 4), 32) * 32), m, True
    cluster = min(_MAX_CLUSTER, _ceil(m, _NARROW))
    slice_ = _ceil(m, cluster)
    return cluster, 1024, slice_, slice_ <= _ON_CHIP


def _check(name, t, dtype, shape):
    if not torch.is_tensor(t) or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        got = (tuple(t.shape), t.dtype) if torch.is_tensor(t) else type(t).__name__
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, got {got}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kmeanspp_centers(points: torch.Tensor, valid: torch.Tensor, k: torch.Tensor, noise: torch.Tensor,
                     log_table: torch.Tensor, k_max: int, weights=None) -> torch.Tensor:
    """(B, k_max, 3) float32 k-means++ initial centres of every row, one
    launch on the current stream.

    points (B, m, 3) float32 integer colours in [0, 255]; valid (B, m) bool;
    k (B,) int64 centres a row (the steps taken: min(k, n_draws, k_max), at
    least 1); noise (n_draws, m) float32, row i the draw of step i for every
    row; log_table float32, the log of every squared distance
    (`ops/cluster.py _log32_table`).  All contiguous on one CUDA device.
    Raises for anything else, weights included (the weighted form has no
    kernel): it never falls back.  The launch is recorded under (B, m,
    n_draws, k_max).
    """
    if weights is not None:
        raise ValueError("weighted k-means++ has no kernel: ops/cluster.py _plusplus_loop seeds it")
    if not torch.is_tensor(points) or points.dim() != 3 or not torch.is_tensor(noise) or noise.dim() != 2:
        raise ValueError("points must be a (B, m, 3) tensor and noise a (n_draws, m) tensor")
    b, m = points.shape[:2]
    n_draws = noise.shape[0]
    k_max = operator.index(k_max)
    if not (b >= 1 and 1 <= m < 2**31 and n_draws >= 1 and k_max >= 1):
        raise ValueError(f"need B >= 1, 1 <= m < 2^31, n_draws >= 1 and k_max >= 1, got {b}, {m}, {n_draws}, {k_max}")
    _check("points", points, torch.float32, (b, m, 3))
    _check("valid", valid, torch.bool, (b, m))
    _check("k", k, torch.int64, (b,))
    _check("noise", noise, torch.float32, (n_draws, m))
    if not torch.is_tensor(log_table) or log_table.dim() != 1 or log_table.numel() < 1:
        raise ValueError("log_table must be a non-empty 1-D tensor")
    _check("log_table", log_table, torch.float32, log_table.shape)
    dev = points.device
    if dev.type != "cuda" or any(t.device != dev for t in (valid, k, noise, log_table)):
        raise ValueError(f"every tensor must be on points' CUDA device, got {dev} "
                         "(the CPU seeds with ops/cluster.py _plusplus_loop)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cluster, threads, slice_, on_chip = plan(m)
    if cluster * b >= 2**31:
        raise ValueError(f"{b} rows of {cluster} blocks pass the grid's limit")
    out = torch.empty((b, k_max, 3), dtype=torch.float32, device=dev)
    scratch = None if on_chip else torch.empty(cluster * b * 5 * slice_, dtype=torch.float32, device=dev)
    _build.launch("kmeanspp", "kmeanspp_launch", dev, points.data_ptr(), valid.data_ptr(), k.data_ptr(),
                  noise.data_ptr(), log_table.data_ptr(), log_table.numel(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b, m, n_draws, k_max, cluster,
                  threads, slice_, key=(b, m, n_draws, k_max))
    if FLOPS.enabled():
        # 12 operations a point and step after the first (3 subtractions, 3
        # multiplications, 2 adds, the minimum, the noise's add, two
        # comparisons), 2 in the first; bytes: the points, valid flags and
        # the noise rows read once, the centres written.
        steps = int(torch.clamp(k, 1, min(n_draws, k_max)).sum())
        used = int(torch.clamp(k, 1, min(n_draws, k_max)).max())
        FLOPS.add(12.0 * m * (steps - b) + 2.0 * m * b,
                  13.0 * b * m + 4.0 * used * m + 8.0 * b + 12.0 * b * k_max)
    return out
