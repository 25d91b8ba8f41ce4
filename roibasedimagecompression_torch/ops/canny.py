"""Canny threshold selection and edge maps: the adaptive sweep on the host
runtime, and the fast single-shot estimator on the device.

The counterpart of the JAX package's `ops/canny.py`: its native path, where
the C++ runtime analyses the image and scores the 20 (low, high) candidates
(`select_thresholds`, `hysteresis_host`, `get_edge_map` of the
reference-shaped loop), and its `fast_edges` mode, which blends
intensity-percentile and gradient-percentile thresholds without a sweep.
Without the runtime the host functions raise naming ROADMAP A13: the JAX
package's device Canny is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import hist as H


def _select_thresholds_native(image_rgb: np.ndarray):
    """(low, high): native analysis + native candidate scoring."""
    native.require("Canny threshold selection")
    gray, mag, nms, cands = native.canny_analysis(image_rgb)
    best = native.score_candidates(gray, mag, nms, cands)
    return float(cands[best][0]), float(cands[best][1])


def select_thresholds(image_rgb: np.ndarray):
    """Adaptive thresholds and the colour gradient: (low, high, mag (h, w)
    float32, nms (h, w) bool), the host runtime's analysis and scoring."""
    low, high = _select_thresholds_native(image_rgb)
    mag_c, nms_c = native.gradient_nms_rgb(image_rgb)
    return low, high, mag_c.astype(np.float32), nms_c


def hysteresis_host(mag: np.ndarray, nms: np.ndarray, low, high) -> np.ndarray:
    """Hysteresis by union-find over the weak graph: the 8-connected
    components of nms & (mag > low) that hold a strong pixel (mag > high)."""
    native.require("Canny hysteresis")
    weak = nms & (mag > low)
    labels, num, _ = native.cc_label(weak, connectivity=8)
    if num == 0:
        return np.zeros(mag.shape, bool)
    strong = nms & (mag > high)
    keep = np.zeros(num + 1, bool)
    keep[labels[strong]] = True
    keep[0] = False
    return keep[labels]


def get_edge_map(image_rgb: np.ndarray):
    """Adaptive Canny: the best-scoring (low, high) of the gray image, then
    Canny on the RGB image.  Returns (edges (h, w) bool, (low, high))."""
    low, high, mag_c, nms_c = select_thresholds(image_rgb)
    return hysteresis_host(mag_c, nms_c, low, high), (float(low), float(high))


def select_thresholds_pair(image_rgb: np.ndarray):
    """Adaptive (low, high) Canny thresholds for one (h, w, 3) uint8 image."""
    return _select_thresholds_native(image_rgb)


def select_thresholds_many(images: np.ndarray):
    """Adaptive thresholds of a (B, h, w, 3) uint8 batch: (lows (B,), highs
    (B,)) float32 arrays, one host analysis and scoring per image."""
    pairs = [_select_thresholds_native(im) for im in images]
    return (np.asarray([p[0] for p in pairs], np.float32),
            np.asarray([p[1] for p in pairs], np.float32))


def fast_thresholds(gray_u8: torch.Tensor):
    """One-shot (low, high) of each image of a (B, h, w) uint8 batch from its
    25th and 75th intensity percentiles (the reference's `percentile_fast`
    law of compute_fast_canny_thresholds); no Canny sweep."""
    g = gray_u8.float().flatten(1)
    every = torch.ones_like(g, dtype=torch.bool)
    low = torch.clamp(torch.floor(H.masked_percentile(g, every, 25.0) * 0.7), 10.0, 100.0)
    high = torch.clamp(torch.floor(H.masked_percentile(g, every, 75.0) * 1.3), 50.0, 200.0)
    high = torch.where(high < low * 2.0, torch.clamp(low * 2.0, max=255.0), high)
    low = torch.clamp(low, 10.0, 100.0)
    high = torch.maximum(low * 2.0, torch.clamp(high, max=200.0))
    return low, high


def _fast_blend_batch(images: torch.Tensor):
    """(B, h, w, 3) uint8 -> (lows, highs) (B,) float32: the fast estimator's
    blend of the percentile thresholds with the 10th and 90th percentiles of
    the non-zero Sobel magnitudes (get_edge_map_fast in the reference).

    gx * gx + gy * gy is exact in float32 (integers, sum < 2^24), so the
    magnitudes are correctly rounded square roots on every device.
    """
    gray = COL.rgb_to_gray_cv2(images)
    low, high = fast_thresholds(gray)
    gx, gy = CONV.sobel_cv2(gray)
    mag = torch.sqrt(gx * gx + gy * gy).flatten(1)
    nz = mag > 0
    glow = H.masked_percentile(mag, nz, 10.0)
    ghigh = H.masked_percentile(mag, nz, 90.0)
    return torch.floor((low + glow) / 2.0), torch.floor((high + ghigh) / 2.0)


def fast_thresholds_many(images: np.ndarray, device) -> tuple:
    """Fast threshold selection of a (B, h, w, 3) uint8 batch on `device`
    (the mode CodecConfig.fast_edges selects): (lows (B,), highs (B,))
    float32 arrays, without the 20-candidate sweep."""
    batch = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(device)
    lows, highs = _fast_blend_batch(batch)
    both = torch.stack([lows, highs]).cpu().numpy().astype(np.float32)
    return both[0], both[1]
