"""Hierarchical palette quantization of the reference-shaped encode loop.

The counterpart of the JAX package's `models/quantize.py`: the three tiers of
the reference clustered one palette at a time.

  tier 1: per SLIC segment   -> cluster palette at q
  tier 2: per region group   -> merge canvases, re-cluster at min(2q, 100)
  tier 3: whole image        -> merge ROI + non-ROI, re-cluster at q2r + q2n

Laws that define the bitstream:
  - black [0, 0, 0] is a background sentinel: never clustered, pinned at
    palette index 0 on merged canvases;
  - DBSCAN(min_samples=1) is the eps-graph's connected components
    (`ops/cluster.eps_components_host`), and a palette of 10,000 colours or
    more takes k-means instead (`ops/cluster.kmeans_host`);
  - clusters larger than max_colors_per_cluster split level-synchronously
    (`quantize_batched._split_oversized_batched`);
  - a cluster's colour is its mean truncated to uint8;
  - canvas merge: coloured pixels override black, the FIRST listed component
    wins where two overlap.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch.models import quantize_batched as QB
from roibasedimagecompression_torch.ops import cluster as C
from roibasedimagecompression_torch.ops import unique as U

BLACK = np.zeros(3, np.uint8)


@dataclasses.dataclass
class Component:
    """An indexed-colour patch placed at top_left on the image canvas."""

    top_left: tuple  # (row, col)
    palette: np.ndarray  # (m, 3) uint8
    indices: np.ndarray  # (h, w) int32

    @property
    def shape(self) -> tuple:
        return self.indices.shape

    def to_rgb(self) -> np.ndarray:
        return self.palette[self.indices]


def from_pixels(patch: np.ndarray, top_left: tuple, device=None) -> Component:
    """A Component with the exact palette of an (h, w, 3) uint8 patch
    (`device` sorts it without the native runtime)."""
    palette, idx = U.unique_colors(patch.reshape(-1, 3), device)
    return Component(
        top_left=tuple(int(v) for v in top_left),
        palette=palette,
        indices=idx.reshape(patch.shape[:2]).astype(np.int32),
    )


def cluster_palette(
    palette: np.ndarray,
    quality: float,
    device,
    *,
    eps: float | None = None,
    max_colors: int | None = None,
    seed: int = 42,
    weights: np.ndarray | None = None,
):
    """Cluster a palette at `quality`: (new_palette (m, 3) uint8, mapping (n,)
    int32 old index -> new index).  Black rows are kept as they are and listed
    first.  weights (optional, per palette entry) make a cluster's colour the
    weighted mean instead of the plain mean of its palette entries."""
    palette = np.asarray(palette, dtype=np.uint8).reshape(-1, 3)
    n = len(palette)
    params = cfg.clustering_params(n, quality)
    if eps is None:
        eps = params.eps
    if max_colors is None:
        max_colors = params.max_colors_per_cluster

    black_mask = np.all(palette == 0, axis=1)
    nb_pos = np.flatnonzero(~black_mask)
    mapping = np.zeros(n, np.int32)
    new_palette: list = []
    for b in np.flatnonzero(black_mask):
        mapping[b] = len(new_palette)
        new_palette.append(BLACK)
    if nb_pos.size == 0:
        return palette.copy(), np.arange(n, dtype=np.int32)

    pts = palette[nb_pos].astype(np.float32)
    if len(nb_pos) >= cfg.KMEANS_SWITCH_COLORS:
        k = cfg.kmeans_n_clusters(len(nb_pos), quality)
        labels = C.kmeans_host(pts, k, device, seed=seed)
    else:
        labels = C.eps_components_host(pts, eps, device)

    # Oversized clusters split with the tier-1 path's level-synchronous
    # splitter, at its defaults (k-means, margin 1, the environment's
    # overrides read there).
    _, cluster_of_point = np.unique(labels, return_inverse=True)
    cluster_of_point = cluster_of_point.astype(np.int64)
    n_clusters = int(cluster_of_point.max()) + 1
    limits = np.full(len(nb_pos), max_colors, np.int64)
    cluster_of_point, n_clusters = QB._split_oversized_batched(
        pts, cluster_of_point, limits, n_clusters, seed, device
    )

    # Mean colour per final cluster, truncated; clusters in id order.
    base = len(new_palette)
    if weights is not None:
        w = np.asarray(weights, np.float64)[nb_pos]
    else:
        w = np.ones(len(nb_pos), np.float64)
    counts = np.bincount(cluster_of_point, weights=w, minlength=n_clusters)
    sums = np.zeros((n_clusters, 3), np.float64)
    for c in range(3):
        sums[:, c] = np.bincount(
            cluster_of_point, weights=pts[:, c].astype(np.float64) * w, minlength=n_clusters
        )
    present = np.flatnonzero(counts > 0)
    compact = np.full(n_clusters, -1, np.int64)
    compact[present] = np.arange(len(present))
    means = (sums[present] / counts[present, None]).astype(np.uint8)
    new_palette.extend(means)
    mapping[nb_pos] = base + compact[cluster_of_point]

    return np.asarray(new_palette, dtype=np.uint8), mapping


def cluster_component(comp: Component, quality: float, device, *, seed: int = 42) -> Component:
    """Palette clustering of one component, its indices remapped."""
    new_palette, mapping = cluster_palette(comp.palette, quality, device, seed=seed)
    return Component(top_left=comp.top_left, palette=new_palette, indices=mapping[comp.indices])


def merge_components(components: list, bbox: tuple) -> Component:
    """Place components on a black canvas over bbox = (minr, minc, maxr,
    maxc): the first listed wins, black never writes, black is palette
    index 0 even where the canvas has none."""
    minr, minc, maxr, maxc = bbox
    h, w = maxr - minr, maxc - minc
    canvas = np.zeros((h, w), np.int32)  # packed 0xRRGGBB; 0 is black
    for comp in reversed(components):
        r0 = comp.top_left[0] - minr
        c0 = comp.top_left[1] - minc
        ch, cw = comp.shape
        packed = (
            (comp.palette[:, 0].astype(np.int32) << 16)
            | (comp.palette[:, 1].astype(np.int32) << 8)
            | comp.palette[:, 2].astype(np.int32)
        )[comp.indices]
        sr0, sc0 = max(0, -r0), max(0, -c0)
        sr1, sc1 = min(ch, h - r0), min(cw, w - c0)
        if sr1 <= sr0 or sc1 <= sc0:
            continue
        view = canvas[r0 + sr0 : r0 + sr1, c0 + sc0 : c0 + sc1]
        patch = packed[sr0:sr1, sc0:sc1]
        np.copyto(view, patch, where=patch != 0)

    values, inverse = np.unique(canvas.reshape(-1), return_inverse=True)
    if values.size == 0 or values[0] != 0:
        values = np.concatenate([[0], values])
        inverse = inverse + 1
    palette = np.stack(
        [(values >> 16) & 0xFF, (values >> 8) & 0xFF, values & 0xFF], axis=1
    ).astype(np.uint8)
    return Component(
        top_left=(int(minr), int(minc)),
        palette=palette,
        indices=inverse.reshape(h, w).astype(np.int32),
    )


def region_quantization(components: list, image_height: int, image_width: int,
                        quality: float, device, *, seed: int = 42) -> Component:
    """Tier 2: merge a region group onto the full canvas and re-cluster."""
    merged = merge_components(components, (0, 0, image_height, image_width))
    return cluster_component(merged, quality, device, seed=seed)


def quantize_image(components: list, image_height: int, image_width: int,
                   quality: float, device, *, seed: int = 42) -> Component:
    """Tier 3: merge everything onto the full canvas and re-cluster."""
    merged = merge_components(components, (0, 0, image_height, image_width))
    return cluster_component(merged, quality, device, seed=seed)


def hierarchical_palette_clustering(palette: np.ndarray, indices: np.ndarray, device,
                                    quality: float = 85.0, *, seed: int = 42):
    """Alternative palette reducer: one k-means over the palette to
    max(2, floor(n * quality / 100)) colours.  Returns (new_palette (k, 3)
    uint8, new_indices of the shape of `indices`)."""
    palette = np.asarray(palette, np.uint8)
    n = len(palette)
    target = max(2, int(n * quality / 100.0))
    if n <= target:
        return palette.copy(), np.asarray(indices).copy()
    labels = C.kmeans_host(palette.astype(np.float32), target, device, seed=seed)
    k = int(labels.max()) + 1
    sums = np.zeros((k, 3), np.float64)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    for c in range(3):
        sums[:, c] = np.bincount(labels, weights=palette[:, c].astype(np.float64), minlength=k)
    new_palette = (sums / np.maximum(counts, 1.0)[:, None]).astype(np.uint8)
    return new_palette, labels[np.asarray(indices)]
