"""XLA's CPU arithmetic order, which the port follows to write the JAX
package's bits.

Two orders, each read from XLA's CPU run on an 8-thread host:
- Eigen's contraction (a convolution's image patches with its kernel, a
  dot's inner dimension): lanes, shards and the sum of their buffers
  (`eigen_lanes`, `eigen_k_shards`, `eigen_combine`).  `ops/conv.py`'s box
  filters, `ops/metrics.py`'s SSIM window and `ops/cluster.py`'s weighted
  centre sums use it.
- XLA's tree reduction of a sum over a map: 32 x 32 windows, then LLVM's
  lanes over their grid (`reduce_windows`, `grid_sum`, `sum_rows`, with
  `fold` and `halves` the sequential and the halving adds).  `ops/metrics.py`
  and `models/segment.py`'s split score use it.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32


# ---------------------------------------------------------------------------
# Eigen's contraction order (XLA's CPU convolution and dot).
#
# XLA runs the JAX package's single-channel convolution as an Eigen
# contraction of the k*k image patches with the kernel (8-float packets).
# Each output pixel adds its taps, in row-major window order, into 8 lanes
# (tap t into lane t % 8, one after another), folds the lanes as
# ((l0 + l1) + (l4 + l5)) + ((l2 + l3) + (l6 + l7)) and adds the last k*k % 8
# taps one by one.  When k*k / 8 > 32 (k = 25), Eigen shards the taps across
# the 8 threads of an 8-core host: blocks of max(96, ceil8(k*k / 8)) taps,
# each summed as above, grouped four by four and combined as
# (b0 + b1) + (b2 + b3) (b0 + ((b1 + b2) + b3) on the last hw % 8 pixels,
# its scalar loop), a shorter group in order, then the groups as the
# blocks.  Read with probes of one 2^24 and two 1.0 values in a window of a
# ones-kernel convolution (the 1.0s survive iff they meet before the 2^24),
# then checked on random binary maps of many sizes.  Like SLIC's centre
# sums (ops/slic.py) this order follows an 8-thread host.
# ---------------------------------------------------------------------------

LANES = 8
SHARDS = 8


def eigen_lanes(tap, taps: range, weight: float | None = None) -> torch.Tensor:
    """Sum of tap(t) over `taps` in Eigen's lane order; with `weight`, of
    tap(t) * weight, each lane's product fused into its addition and the
    last taps' products rounded, as Eigen's kernel does."""
    d8 = len(taps) // LANES * LANES
    lanes = [None] * LANES
    for i in range(d8):
        v = tap(taps[i])
        j = i % LANES
        if weight is not None:
            lanes[j] = fma32(v, weight, 0.0 if lanes[j] is None else lanes[j])
        else:
            lanes[j] = v if lanes[j] is None else lanes[j] + v
    if d8:
        acc = ((lanes[0] + lanes[1]) + (lanes[4] + lanes[5])) + (
            (lanes[2] + lanes[3]) + (lanes[6] + lanes[7])
        )
    else:
        acc = torch.zeros_like(tap(taps[0]))
    for i in range(d8, len(taps)):
        acc = acc + (tap(taps[i]) if weight is None else tap(taps[i]) * weight)
    return acc


def _add4(dst, a, b, c, tail: int):
    """Eigen's addAllToBuffer: (dst + a) + (b + c) over whole packets, and
    dst + ((a + b) + c) over the last `tail` elements of the flat buffer."""
    out = (dst + a) + (b + c)
    if tail:
        flat, d, a_, b_, c_ = (t.reshape(-1) for t in (out, dst, a, b, c))
        flat[-tail:] = d[-tail:] + ((a_[-tail:] + b_[-tail:]) + c_[-tail:])
    return out


def eigen_k_shards(tap, n_taps: int, n_out: int) -> torch.Tensor:
    """Sum of tap(0..n_taps-1) as Eigen's contraction sharded over the taps
    on 8 threads (n_out: output elements, whose last n_out % 8 take the
    scalar loop of the buffer additions)."""
    per_thread = -(-n_taps // SHARDS)
    size = min(n_taps, max(12 * LANES, -(-per_thread // LANES) * LANES))
    blocks = [eigen_lanes(tap, range(s, min(s + size, n_taps))) for s in range(0, n_taps, size)]
    return eigen_combine(blocks, n_out % LANES)


def eigen_combine(blocks: list, tail: int = 0) -> torch.Tensor:
    """Eigen's sum of the block buffers of a contraction sharded over its
    inner dimension: blocks four by four, (b0 + b1) + (b2 + b3) (a shorter
    group in turn), then the groups into the first, three at a time, then
    one by one.  `tail`: the last elements of the flat buffer that take the
    scalar loop (`_add4`)."""

    def reduce(parts):
        if len(parts) == 4:
            return _add4(*parts, tail)
        dst = parts[0]
        for part in parts[1:]:
            dst = dst + part
        return dst

    ranges = [reduce(blocks[s : s + 4]) for s in range(0, len(blocks), 4)]
    dst, i = ranges[0], 1
    while i + 2 < len(ranges):
        dst = _add4(dst, ranges[i], ranges[i + 1], ranges[i + 2], tail)
        i += 3
    while i < len(ranges):
        dst = dst + ranges[i]
        i += 1
    return dst


# ---------------------------------------------------------------------------
# XLA's tree reduction of a sum over a map: 32 x 32 windows (centred zero
# padding) added in row-major order from zero, until both reduced dimensions
# are at most 32, then the grid of window sums in LLVM's lanes
# (`_grid_lanes`).  Read from XLA's dumps (optimized HLO, LLVM IR and the
# object code) and probes; holds for any map size.
# ---------------------------------------------------------------------------

REDUCE_WINDOW = 32


def reduce_windows(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, nr, nc): XLA's 32 x 32 reduce windows (centred zero
    padding), each added in row-major order from zero, until both reduced
    dimensions are at most 32."""
    while x.shape[1] > REDUCE_WINDOW or x.shape[2] > REDUCE_WINDOW:
        n, h, w = x.shape
        wr, wc = min(h, REDUCE_WINDOW), min(w, REDUCE_WINDOW)
        pr, pc = (-h) % wr, (-w) % wc
        if pr or pc:
            x = torch.nn.functional.pad(x, (pc // 2, pc - pc // 2, pr // 2, pr - pr // 2))
        nr, nc = x.shape[1] // wr, x.shape[2] // wc
        v = x.reshape(n, nr, wr, nc, wc).permute(0, 1, 3, 2, 4).reshape(n, nr, nc, wr * wc)
        x = fold(v)
    return x


def fold(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, one element after another from zero.  On the
    CPU numpy's float32 `add.accumulate` (a sequential scan) does it in one
    call; elsewhere one addition per element."""
    if v.device.type == "cpu":
        acc = np.add.accumulate(v.detach().numpy(), axis=-1, dtype=np.float32)[..., -1]
        return torch.from_numpy(np.ascontiguousarray(acc)) + 0.0
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device) + v[..., 0]
    for t in range(1, v.shape[-1]):
        acc = acc + v[..., t]
    return acc


def halves(lanes: list) -> torch.Tensor:
    """Lanes combined as a vector reduction does: halves added pairwise,
    ((0+4)+(2+6))+((1+5)+(3+7)) for 8."""
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
    return lanes[0]


def _grid_lanes(nr: int, nc: int) -> int:
    """Lanes of the final (nr, nc) reduce of a (N, rows, cols) sum, as the
    LLVM vectoriser builds it on the CPU (read by probes of every grid up
    to 32 x 32): rows r go into lane r % lanes, a lane adding its rows'
    elements in order; 1 is one sequential fold."""
    if nc > 8 or nr == 1 or nc == 1:
        return 1
    if nr in (2, 4, 8):
        return nr
    if nr < 16:
        return 1
    if nr % 8 >= 4:
        return 8 if (nc == 2 and nr >= 28) else 4
    return 8 if nc <= 6 else 4


def grid_sum(g: torch.Tensor) -> torch.Tensor:
    """(N, nr, nc) -> (N,): the final reduce in lanes (`_grid_lanes`), the
    lanes combined in halves, then the rows past the last full group."""
    n, nr, nc = g.shape
    k = _grid_lanes(nr, nc)
    if k == 1:
        return fold(g.reshape(n, nr * nc))
    main = nr // k * k
    acc = halves([fold(g[:, j:main:k].reshape(n, -1)) for j in range(k)])
    for r in range(main, nr):
        for c in range(nc):
            acc = acc + g[:, r, c]
    return acc


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,): XLA's sum over the last two dims of a row-major
    (N, H, W) array."""
    return grid_sum(reduce_windows(x))
