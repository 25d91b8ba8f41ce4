"""Seeded k-means rows shared by the tests that hold `ops/cluster.py
kmeans_rows` to the JAX package on the CPU and the tests that hold its card
path to its CPU path.  Imports no JAX."""

import numpy as np

# (ks, k_max, m): k-means++ rows, and seeded random initial centres (k_max > 256),
# the last at tier 1's k_max of a CLIC-sized (2048x1365) photograph
KMEANS_ROWS_CASES = [((5, 17, 2), 32, 1024), ((300, 280, 400), 512, 2048),
                     ((900, 700, 1000), 1024, 4096)]

# (ks, k_max, m, w_max) of the weighted k-means
WEIGHTED_ROWS_CASES = [
    ((5, 9, 2), 16, 64, 300),        # exact sums
    ((5, 9, 2), 16, 256, 400_000),   # sums beyond 2^24, products beyond 2^24: XLA's naive dot
    ((7, 30, 3), 32, 4096, 60_000),  # sums beyond 2^24 over 2048-point chunks: Eigen's order
    ((3, 40, 2), 64, 1024, 300),     # exact sums at the 1024 cap
    ((3, 5, 4), 16, 1024, 723),      # a full-size row: 1024 points of ~370k pixels, sums beyond 2^24
    ((5, 9, 2), 16, 4096, (2000, 0.005)),  # products beyond 2^24 at 2048-point chunks
]


def kmeans_problem(rng, b, m, n_valid):
    centers = rng.integers(0, 256, (b, 9, 3))
    pick = rng.integers(0, 9, (b, m))
    pts = np.clip(
        np.take_along_axis(centers, pick[..., None].repeat(3, -1), 1)
        + rng.integers(-30, 31, (b, m, 3)), 0, 255,
    ).astype(np.float32)
    valid = np.arange(m)[None, :] < np.asarray(n_valid)[:, None]
    pts[~valid] = 0.0
    return pts, valid


def weighted_problem(rng, b, m, n_valid, w_max):
    """Seeded rows of colours around a few centres and integer weights below
    w_max; w_max = (w, share): that share of the points weighs 65,794 to
    400,000 (its products pass 2^24)."""
    pts = np.clip(rng.integers(0, 4, (b, 1, 3)) * 64 + rng.integers(-40, 41, (b, m, 3)), 0, 255)
    pts = pts.astype(np.float32)
    valid = np.arange(m)[None, :] < np.asarray(n_valid)[:, None]
    pts[~valid] = 0.0
    heavy = 0.0
    if isinstance(w_max, tuple):
        w_max, heavy = w_max
    w = rng.integers(1, w_max, (b, m))
    w = np.where(rng.random((b, m)) < heavy, rng.integers(2**24 // 255 + 1, 400_000, (b, m)), w)
    return pts, valid, w.astype(np.float32) * valid


# (B, m, k_max, kind) of the k-means++ seeding, kernel against plain loop:
# tier 1's single wide rows (16,384-131,072 points, and 262,144, whose slices
# stream from global memory), the split buckets' many narrow rows, and rows
# that take the no-finite-logit fallback ("few": fewer distinct colours than
# k), that tie ("ties": duplicate points and noise of repeated values) or that
# are mostly invalid ("sparse", one row with no valid point and one with a
# single one)
KMEANSPP_CASES = [
    (1, 16_384, 256, "clumps"), (1, 32_768, 256, "clumps"), (1, 65_536, 128, "clumps"),
    (1, 131_072, 64, "clumps"), (2, 65_536, 32, "sparse"), (2, 1_024, 2, "ties"),
    (8, 1_024, 256, "few"), (8, 16_384, 16, "ties"), (200, 64, 8, "clumps"),
    (200, 64, 64, "few"), (200, 1_024, 32, "sparse"), (8, 32_768, 100, "ties"),
    (1, 262_144, 32, "clumps"),
]


def seeding_problem(rng, b, m, k_max, kind):
    """Points, valid flags and a different k in each row (the first at k_max,
    the last, where b > 2, at 1) for a KMEANSPP_CASES kind."""
    if kind == "clumps":
        pts, valid = kmeans_problem(rng, b, m, rng.integers(m // 2, m + 1, b))
    else:
        n = {"few": 3, "ties": 20, "sparse": 4096}[kind]
        palette = rng.integers(0, 256, (b, n, 3))
        pick = rng.integers(0, n, (b, m))
        pts = np.take_along_axis(palette, pick[..., None].repeat(3, -1), 1).astype(np.float32)
        valid = rng.random((b, m)) < (0.03 if kind == "sparse" else 0.9)
        if kind == "sparse":
            valid[0] = False
            valid[-1] = np.arange(m) == m // 2
        pts[~valid] = 0.0
    ks = rng.integers(1, k_max + 1, b)
    ks[0] = k_max
    if b > 2:
        ks[-1] = 1
    return pts, valid, ks
