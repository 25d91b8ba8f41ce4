"""ROI mask chain of the reference-shaped loop: edge density -> cleaned,
unified binary ROI map.

The counterpart of the JAX package's `models/roi.py`, stage by stage:

  density filter -> thin-structure removal -> density-aware denoise ->
  morphological closing -> gap bridging -> border-protected unification ->
  hole filling -> small-region cleanup -> ROI/non-ROI split with buffer zone

Connected components and their statistics are host work on the native
runtime (`ops/cc.py`; without it, propagation on the caller's device and
numpy statistics); the filters (box densities, morphology, the distance
transform, the border Sobel) are torch ops on the caller's device, with the
JAX package's CPU bits wherever a threshold reads them.  Stage constants
live in config.RoiConfig.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch.ops import canny as CANNY
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import distance as DIST
from roibasedimagecompression_torch.ops import hist as H
from roibasedimagecompression_torch.ops import morphology as M


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def remove_thin_structures(binary: np.ndarray, density_threshold: float,
                           thinness_threshold: float, window_size: int,
                           min_region_size: int, device) -> np.ndarray:
    """Drop elongated components in low-density areas: thinness = 1 -
    2 * mean(distance) / max(bbox dims); thin components (> thinness_threshold,
    area >= min_region_size) whose mean local density is below
    density_threshold are removed."""
    if not binary.any():
        return binary
    x = _dev(binary, device)
    density = _host(CONV.box_density(x, window_size))
    labels, num = CC.connected_components(binary, connectivity=8, device=device)
    if num <= 1:
        return binary
    dist = _host(DIST.distance_transform_l2(x))
    stats = CC.component_stats(labels, num)
    avg_dist = CC.label_means(labels, dist, num)
    max_dim = np.maximum(stats.width(), stats.height()).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        thinness = 1.0 - np.where(max_dim > 0, (avg_dist * 2.0) / max_dim, 0.0)
    is_thin = (thinness > thinness_threshold) & (stats.areas >= min_region_size)
    is_thin[0] = False
    densities = CC.label_means(labels, density, num)
    drop = np.flatnonzero(is_thin & (densities < density_threshold))
    return CC.remove_labels(binary, labels, drop)


def remove_small_noise_regions(binary: np.ndarray, min_size: int, density_threshold: float,
                               window_size: int, device) -> np.ndarray:
    """Remove small white then small black components, only in low-density
    areas (the density is computed once, from the input)."""
    density = _host(CONV.box_density(_dev(binary, device), window_size))

    def one_pass(mask):
        labels, num = CC.connected_components(mask, connectivity=8, device=device)
        if num <= 1:
            return mask
        areas = CC.component_stats(labels, num).areas
        dens = CC.label_means(labels, density, num)
        drop = np.flatnonzero((areas < min_size) & (dens < density_threshold))
        drop = drop[drop > 0]
        return CC.remove_labels(mask, labels, drop)

    white = one_pass(binary)
    black = one_pass(~white)
    return ~black


def bridge_small_gaps(binary: np.ndarray, max_gap: int, density_threshold: float,
                      local_window: int, regional_window: int, device) -> np.ndarray:
    """Turn black pixels white where the region is dense and white pixels
    lie in opposite directions (within max_gap, inside the local window)."""
    x = _dev(binary, device)
    density = CONV.box_density(x, regional_window)
    # The threshold is a float32 constant, as the JAX package compares it.
    candidates = (~x) & (density > float(np.float32(density_threshold)))
    kernels = CONV.directional_reach_kernels(max_gap, local_window)
    reach = CONV.conv2d_same_multi(x, kernels)
    gaps = torch.zeros_like(x)
    for p in range(4):
        gaps = gaps | (candidates & reach[2 * p] & reach[2 * p + 1])
    return _host(x | gaps)


def detect_meaningful_borders(binary: np.ndarray, sensitivity: float, device) -> np.ndarray:
    """Gradient-based border mask: Sobel magnitude of the 0/1 map above half
    the sensitivity of its maximum, closed and dilated twice (3 x 3)."""
    x = _dev(binary, device).float()
    gx, gy = CONV.sobel_cv2(x[None])
    mag = COL.sqrt32(gx[0] * gx[0] + gy[0] * gy[0])
    mag = mag / torch.clamp(mag.max(), min=1e-12)
    strong = mag > float(np.float32(sensitivity * 0.5))
    ones3 = np.ones((3, 3), bool)
    enhanced = M.close(strong, ones3)
    return _host(M.dilate(enhanced, ones3, iterations=2))


def protect_border_regions(binary: np.ndarray, border: np.ndarray, kernel_size: int,
                           device) -> np.ndarray:
    """Fill internal black noise away from borders: black pixels inside the
    closed white neighbourhood and outside the border zone become white."""
    x = _dev(binary, device)
    closed = M.close(x, np.ones((kernel_size, kernel_size), bool))
    internal = (~x) & closed & (~_dev(border, device))
    return _host(x | internal)


def fill_closed_regions(binary: np.ndarray, min_hole: int, max_hole: int,
                        connectivity: int, device=None) -> np.ndarray:
    """Fill holes of min_hole <= area <= max_hole pixels."""
    labels, num = CC.connected_components(~binary, connectivity=connectivity, device=device)
    if num <= 1:
        return binary
    areas = CC.component_stats(labels, num).areas
    fill = np.flatnonzero((areas >= min_hole) & (areas <= max_hole))
    fill = fill[fill > 0]
    out = binary.copy()
    out[np.isin(labels, fill)] = True
    return out


def remove_small_regions(binary: np.ndarray, min_size: int, device) -> np.ndarray:
    """3 x 3 closing, then drop components below min_size."""
    closed = _host(M.close(_dev(binary, device), np.ones((3, 3), bool)))
    labels, num = CC.connected_components(closed, connectivity=8, device=device)
    if num <= 1:
        return closed
    areas = CC.component_stats(labels, num).areas
    keep = areas >= min_size
    keep[0] = False
    return np.isin(labels, np.flatnonzero(keep))


def roi_masks(image_rgb: np.ndarray, config: cfg.CodecConfig, device):
    """RGB image -> (roi_mask, nonroi_mask) bool maps: the edge map, the
    cleaning chain, the directional unification and the buffer zone."""
    rc = config.roi
    edges, _ = CANNY.get_edge_map(image_rgb, device)
    e = _dev(edges, device)
    density_t = CONV.box_density(e, rc.density_kernel)
    thr = float(H.masked_mean(density_t, e)) / 100.0
    binary = edges & (_host(density_t) > thr)

    binary = remove_thin_structures(
        binary,
        density_threshold=rc.thin_density_threshold,
        thinness_threshold=rc.thin_thinness_threshold,
        window_size=rc.thin_window,
        min_region_size=rc.thin_min_region_size,
        device=device,
    )
    binary = remove_small_noise_regions(
        binary, rc.noise_min_size, rc.noise_density_threshold, rc.noise_window, device
    )
    binary = _host(M.close(_dev(binary, device), M.ellipse_kernel(rc.close_distance * 2 + 1)))
    binary = bridge_small_gaps(
        binary, rc.bridge1_max_gap, rc.bridge1_density,
        rc.bridge_local_window, rc.bridge_regional_window, device,
    )

    # Directional region unification.
    border = detect_meaningful_borders(binary, rc.border_sensitivity, device)
    binary = protect_border_regions(binary, border, rc.border_protect_kernel, device)
    binary = bridge_small_gaps(
        binary, rc.bridge2_max_gap, rc.bridge1_density,
        rc.bridge_local_window, rc.bridge_regional_window, device,
    )
    binary = fill_closed_regions(binary, rc.fill_min_hole, rc.fill_max_hole, connectivity=4,
                                 device=device)
    region_map = remove_small_regions(binary, rc.clean_min_size, device)

    # ROI / non-ROI with a dilated buffer zone shared by both.
    roi_core = _dev(region_map, device)
    nonroi_core = ~roi_core
    roi_exp = M.binary_dilation_scipy(roi_core, iterations=rc.buffer_size)
    nonroi_exp = M.binary_dilation_scipy(nonroi_core, iterations=rc.buffer_size)
    buffer = roi_exp & nonroi_exp
    return _host(roi_core | buffer), _host(nonroi_core | buffer)
