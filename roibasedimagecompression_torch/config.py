"""Codec configuration: every bitstream-visible law of the RHCCQ codec.

These are the same laws, defaults and field names as the JAX package's
`config.py`, so a configuration built there converts losslessly with
`from_dict(dataclasses.asdict(cfg))`.  Each law cites the reference location
it reproduces:

- quality -> DBSCAN params:      encoder/compression/clustering.py:108-135
- tier quality laws (2q, q2+q2): encoder/compression/test.py:116-141
- adaptive size laws:            encoder/ROI/roi.py:17-29, encoder/compression/subregions.py:133
- SLIC working-resolution cap:   encoder/subregions/slic.py:42-44
- ROI mask pipeline constants:   encoder/ROI/roi.py:527-607
- split-score logistic:          encoder/subregions/split_score.py:144-145
- k-means switch at >=10k colors: encoder/compression/clustering.py:207-210
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ClusteringParams:
    """Resolved DBSCAN-style clustering parameters for one palette."""

    eps: float
    min_samples: int
    max_colors_per_cluster: int


def clustering_params(n_colors: int, quality: float) -> ClusteringParams:
    """quality (0-100] -> palette clustering parameters.

      eps = 128 - 1.28*q   (0 -> 1)
      max_colors_per_cluster = ceil((n - n*q/100) / q)   (0 -> 1)
      min_samples = 1  (DBSCAN degenerates to eps-graph connected components)
    """
    eps = 128.0 - 1.28 * float(quality)
    if eps == 0:
        eps = 1.0
    if quality <= 0:
        raise ValueError(f"quality must be > 0, got {quality}")
    max_colors = math.ceil((-(quality / 100.0) * n_colors + n_colors) / quality)
    if max_colors == 0:
        max_colors = 1
    return ClusteringParams(eps=eps, min_samples=1, max_colors_per_cluster=max_colors)


def tier2_quality(q1: float) -> float:
    """Tier-2 (region-group) quality law: q2 = min(2*q1, 100)."""
    return min(2.0 * q1, 100.0)


def tier3_quality(q2_roi: float, q2_nonroi: float) -> float:
    """Tier-3 (whole image) quality law: q3 = min(q2_roi + q2_nonroi, 100)."""
    return min(q2_roi + q2_nonroi, 100.0)


def min_region_size(image_size: int) -> int:
    """ceil(size / 10^(ceil(log10 size) - 3)); `size` counts h*w*3 elements."""
    return math.ceil(image_size / math.pow(10, math.ceil(math.log10(image_size)) - 3))


def segment_window(region_size: int) -> int:
    """Max SLIC segment count for a region of `size` elements (h*w*3):
    ceil(ceil(log10 s) * ln s)."""
    return math.ceil(math.ceil(math.log10(region_size)) * math.log(region_size))


def logistic_segments(score: float, window: int) -> int:
    """Split score (0-1) -> SLIC segment count via a logistic gate."""
    n = math.ceil(window / (1.0 + math.exp(-12.0 * (score - 0.5))))
    return max(1, n)


def slic_scale_factor(max_dim: int) -> float:
    """SLIC working-resolution factor: round(500 / max_dim, 1) clamped to <= 1."""
    s = round(500.0 / float(max_dim), 1)
    return min(s, 1.0)


# Palette size at which clustering switches from DBSCAN to k-means.
KMEANS_SWITCH_COLORS = 10_000

# Largest padded k at which k-means starts from k-means++ (above it, the
# seeded uniform start).
KMEANSPP_MAX_K = 256


def kmeans_n_clusters(n_colors: int, quality: float) -> int:
    """Cluster count for the large-palette k-means path: ceil(n * (q/100) / 10)."""
    return max(1, math.ceil(n_colors * (quality / 100.0) / 10.0))


@dataclasses.dataclass(frozen=True)
class RoiConfig:
    """ROI mask pipeline constants (encoder/ROI/roi.py:527-607 call chain)."""

    density_kernel: int = 3
    thin_density_threshold: float = 0.10
    thin_thinness_threshold: float = 0.3
    thin_window: int = 25
    thin_min_region_size: int = 10
    noise_min_size: int = 75
    noise_density_threshold: float = 0.2
    noise_window: int = 15
    close_distance: int = 5
    bridge1_max_gap: int = 100
    bridge1_density: float = 0.2
    bridge_local_window: int = 15
    bridge_regional_window: int = 25
    border_sensitivity: float = 0.5
    border_protect_kernel: int = 15
    bridge2_max_gap: int = 25
    fill_min_hole: int = 10
    fill_max_hole: int = 10_000
    clean_min_size: int = 5
    buffer_size: int = 3


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Top-level codec configuration (quality preset + pipeline switches).

    Field meanings are those of the JAX package's CodecConfig.  This port runs
    every field: the batched path, with every split method, `fill_black_holes`,
    `region_fusion` and `weighted_split`, and the reference-shaped loop
    (`batched=False`, which `encode_many` ignores, as the JAX package does).
    """

    roi_quality: float = 20.0
    nonroi_quality: float = 10.0
    roi: RoiConfig = dataclasses.field(default_factory=RoiConfig)
    slic_compactness: float = 10.0
    slic_sigma: float = 1.0
    segment_pad: int = 2
    seed: int = 42
    single_region: bool = False
    batched: bool = True
    weighted_palette: bool = True
    region_fusion: bool = False
    fill_black_holes: int = 0
    fast_edges: bool = False
    container_level: int = 10
    split_method: str = "hybrid"
    split_margin: float = 1.5
    weighted_split: bool = False
    palette_refine_iters: int = 2
    palette_refit: bool = True

    @classmethod
    def low_latency(cls, **overrides) -> "CodecConfig":
        """Interactive preset: fewer serial host-device round trips per image.

        fast_edges skips the 20-candidate Canny sweep (the reference's own
        fast mode); split_margin=3.0 collapses the split recursion to one or
        two levels; container_level=7 is a faster entropy stage for a
        slightly larger file.  The eps-CC clustering, SLIC and the split score
        are untouched.
        """
        base = dict(fast_edges=True, split_margin=3.0, container_level=7)
        base.update(overrides)
        return cls(**base)

    @property
    def roi_tier2_quality(self) -> float:
        return tier2_quality(self.roi_quality)

    @property
    def nonroi_tier2_quality(self) -> float:
        return tier2_quality(self.nonroi_quality)

    @property
    def image_quality(self) -> float:
        return tier3_quality(self.roi_tier2_quality, self.nonroi_tier2_quality)


def from_dict(d: dict) -> CodecConfig:
    """Frozen CodecConfig from a plain dict (e.g. `dataclasses.asdict` of the
    JAX package's CodecConfig).  Unknown keys raise TypeError."""
    d = dict(d)
    roi = d.pop("roi", None)
    if roi is not None and not isinstance(roi, RoiConfig):
        roi = RoiConfig(**roi)
    if roi is not None:
        d["roi"] = roi
    return CodecConfig(**d)
