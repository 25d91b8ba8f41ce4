"""Global palette refinement: Lloyd iterations of the FINAL palette against
the tier-1 color table.

The three-tier pipeline assigns every tier-1 cluster a final palette index
through the tier-2/3 cluster merges; those merges optimize each tier's own
objective, not the end-to-end one, so a cluster often sits closer (in RGB)
to some OTHER image's-palette entry than to the one its merge chain picked.
Because the final index is constant per tier-1 cluster, the pixel-level MSE
splits exactly (bias-variance) as

    sum_px ||c - pal[a]||^2 = sum_clusters [within-cluster residual]   (const)
                            + sum_clusters mass * ||mu - pal[a(mu)]||^2

so re-fitting the palette with Lloyd iterations on the (cluster color, pixel
mass) table minimizes the true pixel MSE while touching no pixels.  Measured
on Kodak (4-image probe, defaults): +0.28..+2.31 dB PSNR at +0.04..+0.41 bpp
— a 5.2 dB/bpp marginal slope vs the ~2.6 dB/bpp quality-ladder slope, i.e.
~2x more rate-efficient than raising the quality knobs.

The reference has no counterpart (its tiers emit their merge result
directly, encoder/compression/image.py:243-350); this is an encoder-side
enhancement — the container format and decoder are untouched, and the
reference-parity configs pin palette_refine_iters=0.

Exactness contract: every arithmetic step is exact and grouping-invariant so
the batched (cluster-table) and canvas paths produce bit-identical output:

  - distances via f64 GEMM of uint8-ranged integers (products < 2^16, row
    sums < 2^18 — every partial sum exact, so BLAS order is irrelevant);
  - argmin ties break to the lowest palette index (np.argmin);
  - centroid updates as exact integer sums (np.bincount in f64: terms
    < 2^33, totals < 2^53 — exact, hence order- and grouping-invariant),
    rounded once per iteration;
  - black [0,0,0] is the codec's background sentinel (pinned at palette
    index 0 throughout the tiers, models/quantize.py:11): black palette
    entries are frozen and exactly-black rows pin to the first black entry,
    so refinement never moves background pixels or repainted black segments.
"""

from __future__ import annotations

import numpy as np


def effective_iters(config) -> int:
    """Resolved iteration count: env override, gated off under hole filling
    (filled pixels have background-black tier-1 colors that refinement would
    repaint black)."""
    import os

    v = os.environ.get("RHCCQ_PALETTE_REFINE")
    iters = int(v) if v else config.palette_refine_iters
    return 0 if config.fill_black_holes > 0 else iters


def effective_refit(config) -> bool:
    """Resolved refit switch: env override, gated off under hole filling
    (filled pixels diverge from the original image, which would bias the
    refitted means)."""
    import os

    v = os.environ.get("RHCCQ_PALETTE_REFIT")
    on = bool(int(v)) if v else config.palette_refit
    return on and config.fill_black_holes == 0


def refit_pixels(
    image_rgb: np.ndarray,
    palette: np.ndarray,
    indices: np.ndarray,
) -> np.ndarray:
    """One exact weighted-mean update of the palette against the ORIGINAL
    pixels at FIXED final indices — the Lloyd centroid step of the true
    pixel-MSE objective, with the assignment (and hence the encoded index
    stream) untouched: zero rate cost up to DEFLATE noise on the palette
    bytes, and the MSE cannot increase (each entry moves to its cells'
    mean).  Refinement (`refine_palette`) fits to tier-1 CLUSTER colors,
    which are rounded/black-repaired means — the residual per-entry bias
    against the raw pixels is what this step claims.  Measured (8 Kodak,
    split_margin=1.5): +0.27 dB at identical bpp on the base pipeline,
    +0.10 dB on top of palette_refine_iters=2 (RD_REFINE.json).

    Black palette entries are frozen (codec background sentinel,
    models/quantize.py); rows with no pixels keep their value.  Background
    pixels always map to a frozen black entry (codec.tiers23_palette_indices
    add_black law), so bincounting the FULL image is safe and keeps this
    bit-identical between the canvas and batched paths.  All sums are exact
    (f64 integer accumulation < 2^53), so chunking does not change results.

    Args:
      image_rgb: (h, w, 3) uint8 original image.
      palette: (K, 3) uint8 final palette.
      indices: (h, w) unsigned final index map (pack() input).

    Returns: (K, 3) uint8 refitted palette.
    """
    pal = np.asarray(palette, np.uint8)
    idx = np.asarray(indices).reshape(-1)
    flat = np.asarray(image_rgb, np.uint8).reshape(-1, 3)
    if flat.shape[0] != idx.shape[0]:
        raise ValueError(f"image/index size mismatch: {flat.shape} vs {idx.shape}")
    k = len(pal)
    if k == 0 or idx.size == 0:
        return pal.copy()
    frozen = (pal == 0).all(axis=1)
    if bool(frozen.all()):
        return pal.copy()
    # Chunked exact accumulation: the f64 weight copies stay cache-sized
    # (a full 22 MP f64 view is a ~176 MB/channel transient on the
    # page-fault-sensitive single-core host).
    cnt = np.zeros(k, np.int64)
    sums = np.zeros((k, 3), np.float64)
    chunk = 1 << 22
    for s in range(0, idx.size, chunk):
        ii = idx[s : s + chunk].astype(np.int64, copy=False)
        cnt += np.bincount(ii, minlength=k)
        rows = flat[s : s + chunk]
        for ch in range(3):
            sums[:, ch] += np.bincount(
                ii, weights=rows[:, ch].astype(np.float64), minlength=k
            )
    upd = (~frozen) & (cnt > 0)
    out = pal.copy()
    out[upd] = np.round(sums[upd] / cnt[upd, None]).astype(np.uint8)
    return out


def maybe_refit(image_rgb, palette, indices, config):
    """Apply `refit_pixels` when the config enables it; else pass through."""
    if not effective_refit(config):
        return palette
    return refit_pixels(image_rgb, palette, indices)


def refine_palette(
    colors: np.ndarray,
    mass: np.ndarray,
    palette: np.ndarray,
    iters: int,
) -> tuple:
    """Lloyd-refine `palette` against weighted color rows.

    Args:
      colors: (m, 3) uint8 color rows (tier-1 cluster colors, or unique
        tier-1 canvas colors — grouping does not change the result).
      mass: (m,) pixel counts per row (any integer-valued dtype).
      palette: (K, 3) uint8 initial palette (the tier-3 result).
      iters: Lloyd iterations (0 = identity).

    Returns:
      (palette (K, 3) uint8, assign (m,) int64): refined entry values (order
      preserved; black entries frozen) and the final nearest-entry index per
      row (computed against the final palette).
    """
    palette = np.asarray(palette, np.uint8)
    colors = np.asarray(colors, np.uint8)
    k = len(palette)
    m = len(colors)
    p = palette.astype(np.float64)
    c = colors.astype(np.float64)
    w = np.asarray(mass, np.float64)
    frozen = (palette == 0).all(axis=1)
    has_black = bool(frozen.any())
    black_idx = int(np.flatnonzero(frozen)[0]) if has_black else -1
    black_rows = (colors == 0).all(axis=1) if has_black else None

    c32 = c.astype(np.float32)

    def _assign(p):
        # d2 entries are exact integers < 2^19, and every product/partial sum
        # stays < 2^24 — so f32 GEMM is EXACT (no rounding anywhere), cheaper
        # than f64, and order-independent.  Chunk over rows so the m x K
        # distance block stays cache-sized (a full f64 matrix at
        # m=20k, K=800 cost seconds of page faults on the single-core host).
        p32 = p.astype(np.float32)
        p2 = (p32 * p32).sum(axis=1)
        big = np.float32(np.inf)
        idx = np.empty(len(c32), np.int64)
        chunk = 8192
        for s in range(0, len(c32), chunk):
            rows = c32[s : s + chunk]
            d2 = (rows * rows).sum(axis=1)[:, None] + p2[None, :] - 2.0 * (rows @ p32.T)
            if has_black:
                d2[:, frozen] = big
            idx[s : s + chunk] = np.argmin(d2, axis=1)
        if has_black:
            idx[black_rows] = black_idx
        return idx

    if m == 0 or k == 0 or iters <= 0 or bool(frozen.all()):
        return palette.copy(), (
            np.full(m, max(black_idx, 0), np.int64) if m else np.zeros(0, np.int64)
        )

    prev = None
    for _ in range(iters):
        idx = _assign(p)
        if prev is not None and np.array_equal(idx, prev):
            return p.astype(np.uint8), idx
        prev = idx
        n = np.bincount(idx, weights=w, minlength=k)
        upd = (~frozen) & (n > 0)
        for ch in range(3):
            s = np.bincount(idx, weights=w * c[:, ch], minlength=k)
            p[upd, ch] = np.round(s[upd] / n[upd])
    # Assign-last: indices must be nearest entries of the FINAL palette.
    return p.astype(np.uint8), _assign(p)


def refine_canvas(
    t1_canvas: np.ndarray,
    palette: np.ndarray,
    iters: int,
) -> tuple:
    """Canvas-form refinement: rows are the unique tier-1 canvas colors.

    Background pixels fold into the (frozen) black row, so no mask is needed
    — the result is bit-identical to the cluster-table form.  Returns
    (palette uint8 (K, 3), indices (h, w) minimal unsigned dtype).
    """
    from roibasedimagecompression_torch.io import container as C

    t1_canvas = np.asarray(t1_canvas, np.uint8)
    h, w = t1_canvas.shape[:2]
    flat = t1_canvas.reshape(-1, 3)
    packed = (
        (flat[:, 0].astype(np.int32) << 16)
        | (flat[:, 1].astype(np.int32) << 8)
        | flat[:, 2].astype(np.int32)
    )
    uniq, inv = np.unique(packed, return_inverse=True)
    cols = np.stack(
        [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
    ).astype(np.uint8)
    mass = np.bincount(inv, minlength=len(uniq))
    new_pal, assign = refine_palette(cols, mass, palette, iters)
    dt = C.min_index_dtype(max(len(new_pal) - 1, 0))
    return new_pal, assign[inv].reshape(h, w).astype(dt)
