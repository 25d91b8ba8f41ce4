"""Palette clustering: eps-connectivity components and k-means, batched rows.

DBSCAN(min_samples=1) over palette colours is exactly the set of connected
components of the eps-threshold graph; `eps_components` is the plain driver
over the plain sweep (the CUDA path runs the same driver over the kernel,
ops/cuda/epscc.py).  k-means reproduces the JAX package's `ops/cluster.kmeans`:
k-means++ (or seeded random) initial centres drawn with JAX's threefry bits
(ops/prng.py; the k-means++ noise on a CUDA device by the kernel of
ops/cuda/gumbel.py, elsewhere by `_gumbel_table` on the host; the unweighted
k-means++ steps on a CUDA device by the kernel of ops/cuda/kmeanspp.py,
elsewhere by the plain loop `_plusplus_loop`), the expanded
|a|^2 + |b|^2 - 2ab distance with XLA's fused multiply-adds, first-index
argmin (on a CUDA device the kernel of ops/cuda/lloyd_assign.py, elsewhere
its plain version) and early-exit Lloyd.

With per-point weights (the weighted oversized split, pixel counts) the
k-means++ draws go in proportion to w * d^2 and the centres are weighted
means, as in the JAX package; `_weighted_sums` adds the weighted centre sums
in the order of XLA's CPU run.

`kmeans_host` and `eps_components_host` are the one-problem wrappers of the
reference-shaped encode loop: on a CUDA device the eps components run the
loop kernel (ops/cuda/epscc.py), on the CPU the plain sweep.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops import xla_order as XO
from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.cuda import epscc as EPS
from roibasedimagecompression_torch.ops.cuda import gumbel as GUMBEL
from roibasedimagecompression_torch.ops.cuda import kmeanspp as KPP
from roibasedimagecompression_torch.ops.cuda import lloyd_assign as LLOYD
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import dispatch as DISPATCH
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.timing import stage_timer

_MAX_D2 = 3 * 255 * 255  # the largest squared distance of two uint8 colours


@functools.lru_cache(maxsize=8)
def _log32_table(device: torch.device) -> torch.Tensor:
    """XLA's float32 log (prng.log32) of every squared distance two uint8
    colours can have: the k-means++ logits of integer colours in one gather
    instead of the logarithm's several dozen elementwise steps."""
    return prng.log32(torch.arange(_MAX_D2 + 1, dtype=torch.float32, device=device))


def eps_components(points, eps, valid, groups=None) -> torch.Tensor:
    """Plain eps-graph components of one (n, 3) row: (n,) int32 labels, each
    component labelled by its minimum point index, invalid points n."""
    points = torch.as_tensor(points, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=points.device)
    n = points.shape[0]
    g = (
        torch.zeros(n, dtype=torch.int32, device=points.device)
        if groups is None
        else torch.as_tensor(groups, dtype=torch.int32, device=points.device)
    )
    eps2 = torch.tensor([np.float32(eps) ** 2], dtype=torch.float32, device=points.device)
    labels, _ = EPS.eps_components_rows(
        points[None].contiguous(), valid[None], g[None].contiguous(), eps2,
        sweep=EPS.eps_sweep_ref,
    )
    return labels[0]


@functools.lru_cache(maxsize=8)
def _gumbel_table(seed: int, m: int, n_draws: int) -> np.ndarray:
    """(n_draws, m) float32 Gumbel noise of the k-means++ draws: row 0 is the
    first centre's draw, row i the i-th step's (key, sub = split(key) each,
    `prng.subkey_chain`).  A cache miss draws on the host inside the span
    `kmeans.noise`.  The plain version of the card's kernel
    (`ops/cuda/gumbel.py`)."""
    with stage_timer("kmeans.noise"):
        out = np.empty((n_draws, m), np.float32)
        for i, sub in enumerate(prng.subkey_chain(seed, n_draws)):
            out[i] = prng.gumbel(sub, (m,))
    out.setflags(write=False)
    return out


def _kmeans_noise(seed: int, m: int, n_draws: int, dev: torch.device) -> torch.Tensor:
    """`_gumbel_table(seed, m, n_draws)` on `dev`: on a CUDA device drawn there
    by the kernel (`ops/cuda/gumbel.py`, the same bits) inside the span
    `kmeans.noise`; elsewhere the host table."""
    if dev.type == "cuda":
        with stage_timer("kmeans.noise"):
            return GUMBEL.gumbel_table(seed, m, n_draws, dev)
    return torch.tensor(_gumbel_table(seed, m, n_draws), device=dev)


def _fma_tiny(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """float32 a*b + c with one rounding, for a, b >= 0 and a positive c far
    below half an ulp of a*b (XLA contracts `d2 * w + 1e-20`).  The product
    is exact in float64; c only decides a product that lies exactly halfway
    between two floats, which then rounds up, not to even."""
    p = a.double() * b.double()
    r = p.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    half = (up.double() - r.double()) * 0.5
    r = torch.where((p - r.double()) == half, up, r)
    return torch.where(p > 0, r, torch.full_like(r, float(np.float32(c))))


# ---------------------------------------------------------------------------
# The weighted centre sums in the order of XLA's CPU run.
#
# The JAX package adds them as a one-hot product (weights x points) per chunk
# of min(2048, m) points, the chunks' products added in turn.  XLA hands a
# chunk's product to Eigen as a (3 x K) by (K x chunk) contraction, K the
# centre bucket; each output is a chain of fused multiply-adds over the
# points, in point order from zero, within a span of points, and the spans
# combine as Eigen's heuristics decide on an 8-thread host:
#   - K < 4: one span, the whole chunk;
#   - Eigen's inner-dimension thread count (`_eigen_threads_by_k`, its cost
#     model) 2 or more: spans of max(96, ceil8(chunk / threads)) points,
#     combined as the box filter's shards are (ops/xla_order.py eigen_combine);
#   - else sequential: spans of 256 points (its depth block), added in turn.
# Read with probes of one Lloyd step of the JAX kmeans on rows whose sums and
# products pass 2^24, K from 2 to 256 and 128 to 8192 points.  A centre whose
# products are exact and whose sum stays within 2^24 is exact in any order.
# ---------------------------------------------------------------------------

_EIGEN_THREADS = 8
_EIGEN_KC = 256
_WEIGHTED_CHUNK = 2048


def _eigen_threads_by_k(m: int, n: int, k: int) -> int:
    """Eigen's `numThreadsInnerDim` for an (m x k) by (k x n) float
    contraction on an 8-thread pool: the thread count whose cost-model time
    is least (1 when sharding the inner dimension does not pay)."""
    per_k = 2.0 * m * n / 8 + 11 / 64 * 4 + 11 / 64 * 4 * n
    total = k * per_k
    reduction = m * n * (11 / 64 * 3 + 1 / 8)
    best, low = 1, total
    for nt in range(2, _EIGEN_THREADS + 1, 2):
        cost = total / nt + 100000 + nt * (reduction + 3000)
        if cost < low:
            best, low = nt, cost
    return best


def _weighted_spans(chunk: int, k_max: int) -> tuple:
    """(span length, True where the spans combine four by four) of one
    chunk's contraction."""
    if k_max < 4:
        return chunk, False
    nt = _eigen_threads_by_k(3, k_max, chunk)
    if nt >= 2 and chunk // nt > 32:
        return min(chunk, max(96, -(-(-(-chunk // nt)) // 8) * 8)), True
    return min(chunk, _EIGEN_KC), False


def _fma_chains(chain: torch.Tensor, w: torch.Tensor, pts: torch.Tensor, n_chains: int) -> torch.Tensor:
    """(n_chains, 3) float32: for each chain id, acc = fma(w, point, acc)
    from zero over its entries in the order given.  One step per position
    in the longest chain, every chain at once."""
    dev = pts.device
    acc = torch.zeros((n_chains, 3), dtype=torch.float32, device=dev)
    if chain.numel() == 0:
        return acc
    chain, order = torch.sort(chain, stable=True)
    w, pts = w[order], pts[order]
    first = torch.searchsorted(chain, chain, side="left")
    pos = torch.arange(chain.numel(), device=dev) - first
    by_pos = torch.argsort(pos, stable=True)
    counts = torch.bincount(pos).tolist()
    s = 0
    for n in counts:
        sel = by_pos[s : s + n]
        s += n
        c = chain[sel]
        acc[c] = fma32(w[sel, None], pts[sel], acc[c])
    return acc


def _weighted_sums(labels: torch.Tensor, w: torch.Tensor, points: torch.Tensor,
                   valid: torch.Tensor, k_max: int) -> torch.Tensor:
    """(B, k_max, 3) float32 sums of w * point per label, as the JAX
    package's weighted one-hot product adds them on the CPU (see above).
    Centres that are exact in any order come from one float64 sum; the
    others follow the chains and spans."""
    b, m, _ = points.shape
    dev = points.device
    w = torch.where(valid, w, torch.zeros((), device=dev))
    lab = labels.long()
    if float((w.double().sum(dim=1) * 255.0).max()) < 2**24:  # every row exact: one float32 sum
        sums = torch.zeros((b, k_max, 3), dtype=torch.float32, device=dev)
        return sums.scatter_add_(1, lab[..., None].expand(b, m, 3), w[..., None] * points)
    prod = w.double()[..., None] * points.double()
    total = torch.zeros((b, k_max, 3), dtype=torch.float64, device=dev)
    total.scatter_add_(1, lab[..., None].expand(b, m, 3), prod)
    rounded = torch.zeros((b, k_max), dtype=torch.float64, device=dev)
    rounded.scatter_add_(1, lab, ((prod.float().double() != prod).any(dim=2) & valid).double())
    inexact = (rounded > 0) | (total > 2.0**24).any(dim=2)
    if not bool(inexact.any()):
        return total.float()

    chunk = min(_WEIGHTED_CHUNK, m)
    span, grouped = _weighted_spans(chunk, k_max)
    n_chunks = -(-m // chunk)
    n_spans = -(-chunk // span)
    t = torch.arange(m, device=dev)
    slot = (t // chunk) * n_spans + (t % chunk) // span  # (chunk, span) of each point
    rows, cols = torch.nonzero(inexact[torch.arange(b, device=dev)[:, None], lab] & valid, as_tuple=True)
    n_slots = n_chunks * n_spans
    chain = (rows * n_slots + slot[cols]) * k_max + lab[rows, cols]
    fused = _fma_chains(chain, w[rows, cols], points[rows, cols], b * n_slots * k_max)
    part = torch.zeros((b, n_slots, k_max, 3), dtype=torch.float64, device=dev)
    part.index_put_((torch.arange(b, device=dev)[:, None].expand(b, m), slot[None].expand(b, m), lab),
                    prod, accumulate=True)
    part = torch.where(inexact[:, None, :, None], fused.view(b, n_slots, k_max, 3), part.float())
    part = part.view(b, n_chunks, n_spans, k_max, 3)

    def combine(spans):
        if grouped:  # K >= 64 here, so 3K fills whole packets: no scalar tail
            return XO.eigen_combine(spans)
        out = spans[0]
        for x in spans[1:]:
            out = out + x
        return out

    out = None
    for c in range(n_chunks):
        d = combine([part[:, c, s] for s in range(n_spans)])
        out = d if out is None else out + d
    return out


def _on_card(dev: torch.device) -> bool:
    """Whether `dev` is a CUDA device: the one question the k-means++ and
    assignment routes ask of the device (the tests ask it of a CPU tensor to
    follow the card's route)."""
    return dev.type == "cuda"


def _plusplus_loop(points, valid, k, noise, log_d2, k_max: int, w_pts=None) -> torch.Tensor:
    """(B, k_max, 3) float32 k-means++ initial centres, one Python step a
    centre: the plain version of the card's kernel (`ops/cuda/kmeanspp.py`),
    and the weighted seeding on every device.  noise (n_draws, m), row i the
    draw of step i for every row; log_d2 the log of every squared distance
    (`_log32_table`: squared distances of integer colours are integers <=
    _MAX_D2, and adding 1e-20 to one of them leaves it as it is); with w_pts
    (B, m) the draws go in proportion to w * d^2 (the first to w)."""
    b = points.shape[0]
    dev = points.device
    rows = torch.arange(b, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    n_draws = noise.shape[0]
    if w_pts is None:
        first_logits = torch.where(valid, torch.zeros((), device=dev), neg_inf)
    else:
        pos = valid & (w_pts > 0)
        w_log = prng.log32(torch.where(pos, w_pts + 1e-20, torch.ones((), device=dev)))
        first_logits = torch.where(pos, w_log, neg_inf)
    first = torch.argmax(noise[0][None, :] + first_logits, dim=1)
    centers = torch.zeros((b, k_max, 3), dtype=torch.float32, device=dev)
    centers[:, 0] = points[rows, first]
    min_d2 = ((points - points[rows, first][:, None, :]) ** 2).sum(dim=2)
    min_d2 = torch.where(valid, min_d2, torch.zeros((), device=dev))
    for i in range(1, n_draws):
        g = noise[i]
        if w_pts is None:
            logits = torch.where(valid & (min_d2 > 0), log_d2[min_d2.long()], neg_inf)
        else:
            mass = min_d2 * w_pts
            live = valid & (mass > 0)
            mass = torch.where(live, _fma_tiny(min_d2, w_pts, 1e-20),
                               torch.ones((), device=dev))
            logits = torch.where(live, prng.log32(mass), neg_inf)
        has = torch.isfinite(logits).any(dim=1, keepdim=True)
        logits = torch.where(
            has, logits, torch.where(valid, torch.zeros((), device=dev), neg_inf)
        )
        idx = torch.argmax(g[None, :] + logits, dim=1)
        new_center = points[rows, idx]
        active = (i < k)[:, None]
        centers[:, i] = torch.where(active, new_center, centers[:, i])
        d2_new = ((points - new_center[:, None, :]) ** 2).sum(dim=2)
        min_d2 = torch.where(active, torch.minimum(min_d2, d2_new), min_d2)
    return centers


def kmeans_rows(
    points: torch.Tensor,
    valid: torch.Tensor,
    k,
    *,
    k_max: int,
    iters: int = 25,
    seed: int = 42,
    plusplus: bool = True,
    init_centers: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Lloyd k-means on each row of a padded batch; (B, m) int32 labels.

    points (B, m, 3) float32 integer colours in [0, 255] (the k-means++
    logits are read from a table of squared distances); valid (B, m) bool; k (B,) the
    per-row cluster count (<= k_max).  Every row draws from the same key
    sequence (the JAX kernel is vmapped with a static seed), so one noise
    vector per k-means++ step serves the whole batch.  init_centers (B,
    k_max, 3) float32, when given, are the initial centres and no draw is
    made; rows >= k are masked out of every assignment, whatever they hold.
    weights (B, m) float32, when given: the k-means++ draws go in proportion
    to w * d^2 (the first in proportion to w) and the centres are weighted
    means; the assignment is unchanged.

    Every assignment pass, each Lloyd pass and the last, labels every
    point of the padded batch with its nearest valid centre, first index on
    ties.  On a CUDA device it is one launch of the kernel
    (`ops/cuda/lloyd_assign.py assign_labels`) over the whole batch; on the
    CPU its plain version (`assign_plain`), which computes the same
    distances over chunks of points.  The labels are the same on both.

    Traced as the spans `kmeans.seed` (the initial centres) and
    `kmeans.lloyd` (the loop and the last assignment), and the counters
    `kmeans_iters` (Lloyd iterations run), `kmeans_assign_pairs` (over every
    assignment pass, the Lloyd passes and the last: the sum over rows of
    valid points x that row's k, unpadded), `kmeans_seed.kernel` /
    `kmeans_seed.loop` (one per k-means++ seeding, by route: the card's
    kernel, or the plain loop on the CPU and for weighted seeding),
    `kmeans_assign.card` / `kmeans_assign.host` (one per assignment pass, by
    route) and `kmeans_init.uniform` (one per uniform start;
    `utils/timing.py`).
    """
    b, m, _ = points.shape
    dev = points.device
    on_card = _on_card(dev)
    k = torch.as_tensor(np.asarray(k, np.int64), device=dev)
    kvec = k.cpu().numpy()
    rows = torch.arange(b, device=dev)
    key = prng.prng_key(seed)
    w_pts = None
    if weights is not None:
        w_pts = torch.where(valid, weights.to(device=dev, dtype=torch.float32),
                            torch.zeros((), device=dev))

    with stage_timer("kmeans.seed"):
        if init_centers is not None:
            centers = init_centers.to(device=dev, dtype=torch.float32)
        elif plusplus:
            n_draws = max(int(kvec.max()), 1)
            log_d2 = _log32_table(dev)
            noise = _kmeans_noise(int(seed), m, n_draws, dev)
            if on_card and w_pts is None:
                timing.count("kmeans_seed.kernel", 1)
                centers = KPP.kmeanspp_centers(points.contiguous(), valid.contiguous(), k, noise,
                                               log_d2, k_max)
            else:
                timing.count("kmeans_seed.loop", 1)
                centers = _plusplus_loop(points, valid, k, noise, log_d2, k_max, w_pts)
        else:
            timing.count("kmeans_init.uniform", 1)
            u = torch.from_numpy(prng.uniform(key, (m,))).to(dev)
            scores = u[None, :] + torch.where(
                valid, torch.zeros((), device=dev), torch.full((), 2.0, device=dev)
            )
            order = torch.sort(scores, dim=1, stable=True).indices
            take = order[:, torch.arange(k_max, device=dev) % m]
            centers = points[rows[:, None], take]

    def assign(c):
        if on_card:
            timing.count("kmeans_assign.card", 1)
            return LLOYD.assign_labels(points.contiguous(), c.contiguous(), k, k_max)
        timing.count("kmeans_assign.host", 1)
        return LLOYD.assign_plain(points, c, k, k_max)

    validf = valid.float()
    pts_v = points * validf[..., None]

    def update(labels, c):
        counts = torch.zeros((b, k_max), dtype=torch.float32, device=dev)
        if w_pts is None:
            # Integer colours, unweighted: the sums are exact in float32
            # while every centre has at most 65,793 members (255 * 65,793 <
            # 2^24), and then their order is irrelevant.
            sums = torch.zeros((b, k_max, 3), dtype=torch.float32, device=dev)
            sums.scatter_add_(1, labels[..., None].expand(b, m, 3), pts_v)
            counts.scatter_add_(1, labels, validf)
        else:
            # Pixel counts: integer totals below 2^24, exact in any order.
            sums = _weighted_sums(labels, w_pts, pts_v, valid, k_max)
            counts.scatter_add_(1, labels, w_pts)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        return torch.where(counts[..., None] > 0, new, c)

    with stage_timer("kmeans.lloyd"):
        prev = torch.full((b, m), -1, dtype=torch.int64, device=dev)
        pairs = (valid.sum(dim=1) * k).sum()  # of one assignment pass: valid points x k, all rows
        run = 0
        for _ in range(iters):
            labels = assign(centers)
            centers = update(labels, centers)
            changed = (labels != prev).any()
            if run == 0:  # the pair count comes back with the first pass's wait
                changed, pairs = torch.stack([changed.long(), pairs]).tolist()
            prev = labels
            run += 1
            if not changed:
                break
        out = assign(centers).int()
    timing.count("kmeans_iters", run)
    timing.count("kmeans_assign_pairs", int(pairs) * (run + 1))
    return out


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def kmeans_host_many(problems: list, device, *, seed: int = 42, iters: int = 25) -> list:
    """k-means labels (numpy int32) for many (points (n, 3), k) problems,
    each padded to a power-of-two row as the JAX package pads it.  Every
    problem's call goes out first; the labels come back with one wait
    (`parallel/shard.py collect_all`)."""
    pending = []
    for points, k in problems:
        points = np.asarray(points, dtype=np.float32)
        n = points.shape[0]
        if k <= 1 or n <= 1:
            pending.append((n, None))
            continue
        k = min(k, n)
        n_pad = _bucket(n)
        k_max = _bucket(k, minimum=2)
        pts = np.zeros((1, n_pad, 3), np.float32)
        pts[0, :n] = points
        valid = np.zeros((1, n_pad), bool)
        valid[0, :n] = True
        labels = DISPATCH.call(
            kmeans_rows, torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device),
            np.asarray([k]), k_max=k_max, iters=iters, seed=seed,
            plusplus=k_max <= cfg.KMEANSPP_MAX_K,
        )
        pending.append((n, labels))
    collected = iter(SHARD.collect_all([lab[0] for _, lab in pending if lab is not None]))
    return [np.zeros(n, np.int32) if lab is None else next(collected)[:n] for n, lab in pending]


def kmeans_host(points, k: int, device, *, seed: int = 42, iters: int = 25) -> np.ndarray:
    """k-means labels (numpy int32) of one (n, 3) problem, padded to a power
    of two with k-means++ when the padded k is at most 256: the JAX package's
    `kmeans_host`, whose arithmetic is that of its `kmeans_host_many`."""
    return kmeans_host_many([(points, k)], device, seed=seed, iters=iters)[0]


def eps_components_host(points, eps: float, device, groups=None) -> np.ndarray:
    """eps-graph component labels (numpy int32) of one (n, 3) row of integer
    colours: each component labelled by its least point index.

    On a CUDA device the row is padded to a power of two, as the JAX package
    pads it, and takes one launch of the loop kernel (kernel 2, the
    counterpart of the JAX package's `eps_components_pallas`); on the CPU the
    plain sweep.  The labels are the same on both, and equal to both of the
    JAX package's routes (its XLA sweep and its Pallas kernel).  `groups`
    (n,) int32, optional: edges join equal groups only.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    dev = torch.device(device)
    g = np.zeros(n, np.int32) if groups is None else np.asarray(groups, np.int32)
    if dev.type != "cuda":
        return eps_components(torch.from_numpy(np.ascontiguousarray(pts)), eps,
                              torch.ones(n, dtype=torch.bool), torch.from_numpy(g)).numpy()
    n_pad = _bucket(n)
    rows = np.zeros((1, n_pad, 3), np.float32)
    rows[0, :n] = pts
    grp = np.full((1, n_pad), -1, np.int32)
    grp[0, :n] = g
    valid = torch.arange(n_pad, device=dev)[None, :] < n
    eps2 = torch.tensor([np.float32(eps) ** 2], dtype=torch.float32, device=dev)
    labels, _ = EPS.eps_components_rows(
        torch.from_numpy(rows).to(dev), valid, torch.from_numpy(grp).to(dev), eps2
    )
    return labels[0, :n].cpu().numpy()
