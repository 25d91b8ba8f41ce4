"""ROI / non-ROI masks: the host runtime's mask pipeline, or the JAX
package's fused device graph (`roi_masks_device`).

The counterpart of the JAX package's `models/roi_fused.py`.  With the native
runtime, `roi_masks_fast` is its C++ pipeline.  The device graph runs the
same chain as torch ops on the caller's device: density filter, thin-
structure removal, density-aware denoise, closing, gap bridging, border-
protected unification, hole filling, cleanup, buffer-zone split.  It is
what `roi_masks` runs with `fast_edges` off, whether the runtime loads or not
(so `encode_debug` reaches it everywhere), and what every path runs without
the runtime (RHCCQ_NATIVE=0).

Per-component statistics come from min-label propagation (`ops/cc.py`).
Where a statistic is a float32 sum compared with a threshold (mean
distances and densities), the JAX package's `segment_sum` is XLA's CPU
scatter-add, which adds a segment's values one after another in pixel order;
the port adds them in that order with numpy's unbuffered `add.at` on the
host, since no torch scatter on the card fixes its order.  Counts are exact
integers, summed on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.ops import canny as CANNY
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import distance as DIST
from roibasedimagecompression_torch.ops import hist as H
from roibasedimagecompression_torch.ops import morphology as M
from roibasedimagecompression_torch.utils import device as DEV


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fold_sums(values: torch.Tensor, flat: torch.Tensor, n_seg: int) -> torch.Tensor:
    """float32 per-segment sums of `values`, each segment's values added one
    after another in pixel order (XLA's CPU scatter-add), on the host."""
    acc = np.zeros(n_seg, np.float32)
    np.add.at(acc, flat.cpu().numpy(), values.reshape(-1).float().cpu().numpy())
    return torch.from_numpy(acc).to(values.device)


def _labels(mask: torch.Tensor, connectivity: int = 8):
    """(flat segment of each pixel, h * w for the background; pixel counts
    per segment as float32)."""
    h, w = mask.shape
    labels = CC.propagate_labels(mask, connectivity=connectivity)
    flat = torch.where(mask, labels, h * w).reshape(-1)
    counts = torch.bincount(flat, weights=mask.reshape(-1).double(), minlength=h * w + 1).float()
    return flat, counts


def _per_component(mask: torch.Tensor, *values, connectivity: int = 8):
    """(flat labels, pixel count at each pixel, [value sum at each pixel])."""
    h, w = mask.shape
    flat, counts = _labels(mask, connectivity)
    zero = torch.zeros((), device=mask.device)
    sums_at = [_fold_sums(torch.where(mask, v, zero), flat, h * w + 1)[flat].reshape(h, w)
               for v in values]
    return flat, counts[flat].reshape(h, w), sums_at


def _remove_thin_structures(binary: torch.Tensor, rc: cfg.RoiConfig) -> torch.Tensor:
    """thinness = 1 - 2 * mean(EDT) / max(bbox dim); thin components in
    low-density areas are dropped."""
    h, w = binary.shape
    dev = binary.device
    density = CONV.box_density(binary, rc.thin_window)
    dist = DIST.distance_transform_l2(binary)
    flat, counts = _labels(binary)
    zero = torch.zeros((), device=dev)
    n_seg = h * w + 1
    dist_sum = _fold_sums(torch.where(binary, dist, zero), flat, n_seg)
    dens_sum = _fold_sums(torch.where(binary, density, zero), flat, n_seg)
    fg = binary.reshape(-1)
    rows = torch.arange(h, device=dev)[:, None].expand(h, w).reshape(-1)
    cols = torch.arange(w, device=dev)[None, :].expand(h, w).reshape(-1)
    big = h + w + 2

    def seg_min(v):
        out = torch.full((n_seg,), big, dtype=torch.int64, device=dev)
        return out.scatter_reduce(0, flat, torch.where(fg, v, big), reduce="amin")

    def seg_max(v):
        out = torch.full((n_seg,), -big, dtype=torch.int64, device=dev)
        return out.scatter_reduce(0, flat, torch.where(fg, v, -big), reduce="amax")

    # Integer extents, exact; as float32 they are the JAX package's values.
    max_dim = torch.maximum(seg_max(rows) - seg_min(rows) + 1,
                            seg_max(cols) - seg_min(cols) + 1).float()
    one = torch.ones((), device=dev)
    avg_dist = dist_sum / torch.maximum(counts, one)
    mean_dens = dens_sum / torch.maximum(counts, one)
    thinness = 1.0 - torch.where(max_dim > 0, (avg_dist * 2.0) / max_dim, zero)
    drop = ((thinness > _f32(rc.thin_thinness_threshold))
            & (counts >= rc.thin_min_region_size)
            & (mean_dens < _f32(rc.thin_density_threshold)))
    return binary & ~drop[flat].reshape(h, w)


def _remove_small_noise(binary: torch.Tensor, rc: cfg.RoiConfig) -> torch.Tensor:
    """Small low-density white components, then black ones, removed (the
    density is computed once, from the input)."""
    density = CONV.box_density(binary, rc.noise_window)

    def one_pass(mask):
        _, count_at, (dens_at,) = _per_component(mask, density)
        mean_dens = dens_at / torch.clamp(count_at, min=1.0)
        drop = (count_at < rc.noise_min_size) & (mean_dens < _f32(rc.noise_density_threshold))
        return mask & ~drop

    white = one_pass(binary)
    return ~one_pass(~white)


def _bridge_gaps(binary: torch.Tensor, max_gap: int, rc: cfg.RoiConfig) -> torch.Tensor:
    density = CONV.box_density(binary, rc.bridge_regional_window)
    candidates = (~binary) & (density > _f32(rc.bridge1_density))
    kernels = CONV.directional_reach_kernels(max_gap, rc.bridge_local_window)
    reach = CONV.conv2d_same_multi(binary, kernels)
    gaps = torch.zeros_like(binary)
    for p in range(4):
        gaps = gaps | (candidates & reach[2 * p] & reach[2 * p + 1])
    return binary | gaps


def _fill_closed_regions(binary: torch.Tensor, rc: cfg.RoiConfig) -> torch.Tensor:
    inverted = ~binary
    _, count_at, _ = _per_component(inverted, connectivity=4)
    fill = inverted & (count_at >= rc.fill_min_hole) & (count_at <= rc.fill_max_hole)
    return binary | fill


def _remove_small_regions(binary: torch.Tensor, min_size: int) -> torch.Tensor:
    closed = M.close(binary, np.ones((3, 3), bool))
    _, count_at, _ = _per_component(closed)
    return closed & (count_at >= min_size)


def roi_masks_device(image: torch.Tensor, rc: cfg.RoiConfig, low, high):
    """(h, w, 3) uint8 image on its device and Canny thresholds -> (roi_mask,
    nonroi_mask) bool tensors: the JAX package's fused mask graph."""
    mag, nms = CANNY.gradient_and_nms(image, rgb=True)
    edges = CANNY.hysteresis(mag, nms, _f32(low), _f32(high))

    density = CONV.box_density(edges, rc.density_kernel)
    # Edge pixels have densities >= 1/9 and the threshold is at most 0.01,
    # so the mean's last bits cannot move the mask.
    thr = float(H.masked_mean(density, edges)) * _f32(0.01)
    binary = edges & (density > thr)

    binary = _remove_thin_structures(binary, rc)
    binary = _remove_small_noise(binary, rc)
    binary = M.close(binary, M.ellipse_kernel(rc.close_distance * 2 + 1))
    binary = _bridge_gaps(binary, rc.bridge1_max_gap, rc)

    # Directional unification.
    x = binary.float()
    gx, gy = CONV.sobel_cv2(x[None])
    gmag = COL.sqrt32(gx[0] * gx[0] + gy[0] * gy[0])
    gmag = gmag / torch.clamp(gmag.max(), min=1e-12)
    strong = gmag > _f32(rc.border_sensitivity * 0.5)
    ones3 = np.ones((3, 3), bool)
    border = M.dilate(M.close(strong, ones3), ones3, iterations=2)

    closed_white = M.close(binary, np.ones((rc.border_protect_kernel,) * 2, bool))
    binary = binary | ((~binary) & closed_white & (~border))

    binary = _bridge_gaps(binary, rc.bridge2_max_gap, rc)
    binary = _fill_closed_regions(binary, rc)
    region_map = _remove_small_regions(binary, rc.clean_min_size)

    roi_exp = M.binary_dilation_scipy(region_map, iterations=rc.buffer_size)
    nonroi_exp = M.binary_dilation_scipy(~region_map, iterations=rc.buffer_size)
    buffer = roi_exp & nonroi_exp
    return region_map | buffer, (~region_map) | buffer


def _device_masks(image_rgb: np.ndarray, config: cfg.CodecConfig, low, high, device):
    img = torch.from_numpy(np.ascontiguousarray(image_rgb, np.uint8)).to(DEV.or_cpu(device))
    roi, nonroi = roi_masks_device(img, config.roi, low, high)
    return roi.cpu().numpy(), nonroi.cpu().numpy()


def roi_masks(image_rgb: np.ndarray, config: cfg.CodecConfig, device=None):
    """Adaptive thresholds, then the masks (`encode_debug`'s frontend).  With
    `fast_edges` the fast estimator and the host pipeline (the device graph
    without the runtime); otherwise always the device graph."""
    if config.fast_edges:
        lows, highs = CANNY.fast_thresholds_many(
            np.asarray(image_rgb)[None], DEV.or_cpu(device))
        return roi_masks_fast(image_rgb, config, float(lows[0]), float(highs[0]), device)
    low, high = CANNY.select_thresholds_pair(image_rgb, device)
    return _device_masks(image_rgb, config, low, high, device)


def roi_masks_fast(image_rgb: np.ndarray, config: cfg.CodecConfig, low, high, device=None):
    """(roi_mask, nonroi_mask) bool arrays for Canny thresholds (low, high):
    the host runtime's pipeline, or without it the device graph on `device`
    (the CPU when None)."""
    out = native.roi_pipeline(image_rgb, float(low), float(high), config.roi)
    if out is not None:
        return out
    return _device_masks(image_rgb, config, low, high, device)
