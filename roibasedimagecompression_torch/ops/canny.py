"""Canny threshold selection and edge maps.

The counterpart of the JAX package's `ops/canny.py`.  With the native
runtime, the C++ code analyses the image and scores the 20 (low, high)
candidates (`select_thresholds`, `hysteresis_host`, `get_edge_map` of the
reference-shaped loop).  Without it (RHCCQ_NATIVE=0) the JAX package's
device Canny runs on the caller's device: the Sobel gradient and
non-maximum suppression once, the candidate table (`adaptive_thresholds`),
and hysteresis as min-key propagation over the weak graph (`ops/cc.py`), all
20 candidates in one batched propagation (`edge_quality_scores`).  The
`fast_edges` mode blends intensity-percentile and gradient-percentile
thresholds without a sweep, on the device either way.

The gradients, the hysteresis and the candidate bounds are integer work or
floors, exact on every device.  The float reductions (the gradient's mean
and standard deviation, the edge contrast, Otsu's class means) are summed in
float64 and rounded to float32, then combined in float32 with XLA's fused
multiply-adds where the JAX functions (jitted) contract them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import hist as H
from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import device as DEV
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.timing import stage_timer

_TAN22 = float(np.float32(math.tan(math.pi / 8.0)))
_TAN67 = float(np.float32(math.tan(3.0 * math.pi / 8.0)))
_STRONG_OFFSET = 1 << 30
_SENS = [float(np.float32(s)) for s in (0.5, 0.7, 1.0, 1.3, 1.5)]


# ---------------------------------------------------------------------------
# Device Canny (the JAX package's graphs).
# ---------------------------------------------------------------------------


def _sobel_replicate(gray: torch.Tensor):
    """3x3 Sobel (gx, gy) of (..., h, w) with replicate borders, cv2.Canny's
    own border mode.  Integer taps on integer values: exact in any order."""
    g = gray.float()
    h, w = g.shape[-2:]
    p = torch.nn.functional.pad(g[None] if g.dim() == 2 else g, (1, 1, 1, 1), mode="replicate")
    if g.dim() == 2:
        p = p[0]

    def at(dy, dx):
        return p[..., dy : dy + h, dx : dx + w]

    gx = (at(0, 2) - at(0, 0)) + 2.0 * (at(1, 2) - at(1, 0)) + (at(2, 2) - at(2, 0))
    gy = (at(2, 0) - at(0, 0)) + 2.0 * (at(2, 1) - at(0, 1)) + (at(2, 2) - at(0, 2))
    return gx, gy


def gradient_and_nms(image: torch.Tensor, rgb: bool):
    """Gradient magnitude (L1, float32) and the non-maximum-suppression
    survivors of (..., h, w) uint8 gray images, or of (..., h, w, 3) RGB
    images (rgb=True: the per-pixel channel of largest magnitude, the first
    on ties).  cv2's sectors: horizontal if |gy| < tan(22.5) |gx|, vertical
    if |gy| > tan(67.5) |gx|, else diagonal signed by gx * gy."""
    if rgb:
        parts = [_sobel_replicate(image[..., c]) for c in range(3)]
        mags = torch.stack([gx.abs() + gy.abs() for gx, gy in parts])
        best = torch.argmax(mags, dim=0)
        mag = torch.gather(mags, 0, best[None])[0]
        gx = torch.gather(torch.stack([p[0] for p in parts]), 0, best[None])[0]
        gy = torch.gather(torch.stack([p[1] for p in parts]), 0, best[None])[0]
    else:
        gx, gy = _sobel_replicate(image)
        mag = gx.abs() + gy.abs()
    ax, ay = gx.abs(), gy.abs()
    horizontal = ay < _TAN22 * ax
    vertical = ay > _TAN67 * ax
    diag = ~horizontal & ~vertical
    same_sign = (gx * gy) >= 0

    def keep(a, b):
        return (mag > a) & (mag >= b)

    pass_h = keep(CC.shifted(mag, 0, -1, 0.0), CC.shifted(mag, 0, 1, 0.0))
    pass_v = keep(CC.shifted(mag, -1, 0, 0.0), CC.shifted(mag, 1, 0, 0.0))
    pass_d1 = keep(CC.shifted(mag, -1, -1, 0.0), CC.shifted(mag, 1, 1, 0.0))
    pass_d2 = keep(CC.shifted(mag, -1, 1, 0.0), CC.shifted(mag, 1, -1, 0.0))
    nms = ((horizontal & pass_h) | (vertical & pass_v)
           | (diag & same_sign & pass_d1) | (diag & ~same_sign & pass_d2))
    return mag, nms


def hysteresis_labeled(mag: torch.Tensor, nms: torch.Tensor, low, high):
    """Hysteresis of (..., h, w) maps, with low / high broadcast over the
    leading axes: min-key propagation over the weak graph, the strong pixels'
    keys offset by -2^30, so a component's minimum is negative iff it holds a
    strong pixel.  Returns (edges, kept components, edge pixels), the counts
    per leading index."""
    low = torch.as_tensor(low, dtype=torch.float32, device=mag.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=mag.device)
    while low.dim() < mag.dim():
        low, high = low[..., None], high[..., None]
    weak = nms & (mag > low)
    strong = nms & (mag > high)
    h, w = mag.shape[-2:]
    ids = torch.arange(h * w, dtype=torch.int64, device=mag.device).reshape(h, w)
    keys = torch.where(strong, ids - _STRONG_OFFSET, ids)
    prop = CC.propagate_keys(keys, weak, connectivity=8)
    edges = weak & (prop < 0)
    n_comp = ((prop == keys) & edges).sum(dim=(-2, -1))
    return edges, n_comp, edges.sum(dim=(-2, -1))


def hysteresis(mag: torch.Tensor, nms: torch.Tensor, low, high) -> torch.Tensor:
    """Edges: NMS survivors above `low` 8-connected to one above `high`."""
    return hysteresis_labeled(mag, nms, low, high)[0]


def canny(image: torch.Tensor, low, high) -> torch.Tensor:
    """cv2.Canny analogue of an (h, w, 3) uint8 RGB image -> bool edges."""
    mag, nms = gradient_and_nms(image, rgb=True)
    return hysteresis(mag, nms, float(np.float32(low)), float(np.float32(high)))


def otsu_threshold(gray_u8: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of each (..., h, w) uint8 image, as float32: the
    first bin maximising the between-class variance (background <= t)."""
    flat = gray_u8.reshape(*gray_u8.shape[:-2], -1).long()
    hist = torch.zeros((*flat.shape[:-1], 256), dtype=torch.float64, device=flat.device)
    hist.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float64))
    hist = hist.float()  # pixel counts: exact
    bins = torch.arange(256, dtype=torch.float32, device=flat.device)
    total = hist.sum(dim=-1, keepdim=True)
    w0 = torch.cumsum(hist.double(), dim=-1).float()
    sum0 = _cumsum32(hist * bins)
    mu_total = sum0[..., -1:]
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1e-9)
    mu1 = (mu_total - sum0) / torch.clamp(w1, min=1e-9)
    d = mu0 - mu1
    between = (w0 * w1) * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, torch.full_like(between, -1.0))
    return torch.argmax(between, dim=-1).float()


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Running float32 sums along the last axis, added one after another
    (XLA's CPU cumulative sum)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def _clip_pair(low, high):
    low = torch.clamp(low, 10.0, 200.0)
    high = torch.minimum(torch.maximum(high, low + 10.0), torch.full_like(high, 255.0))
    return low, high


def adaptive_thresholds(gray_u8: torch.Tensor) -> torch.Tensor:
    """The 20 (low, high) candidates of each (..., h, w) uint8 gray image:
    4 methods (otsu, percentile, gradient, hybrid) x sensitivities [0.5,
    0.7, 1.0, 1.3, 1.5], method-major.  (..., 20, 2) float32."""
    otsu = otsu_threshold(gray_u8)
    lead = gray_u8.shape[:-2]
    gx, gy = CONV.sobel_cv2(gray_u8.reshape(-1, *gray_u8.shape[-2:]).float())
    grad = COL.sqrt32(gx * gx + gy * gy).reshape(*lead, -1)
    nz = grad > 0
    p70 = H.masked_percentile(grad, nz, 70.0)
    p90 = H.masked_percentile(grad, nz, 90.0)
    any_nz = nz.any(dim=-1)
    n = grad.shape[-1]
    mean_g = (grad.double().sum(dim=-1) / n).float()
    var_g = ((grad.double() - mean_g.double()[..., None]) ** 2).sum(dim=-1) / n
    std_g = COL.sqrt32(var_g.float())

    def floor(x):
        return torch.floor(x)

    ten = torch.full_like(otsu, 10.0)
    top = torch.full_like(otsu, 255.0)
    pairs = []
    for s in _SENS:
        # XLA folds the constant factors of otsu * 0.5 * s into one.
        lo = torch.maximum(ten, floor(otsu * float(np.float32(0.5) * np.float32(s))))
        hi = torch.minimum(top, floor(otsu * float(np.float32(1.5) * np.float32(s))))
        pairs.append(_clip_pair(lo, hi))
    for s in _SENS:
        lo = torch.where(any_nz, p70 * s, torch.full_like(p70, 50.0 * s))
        hi = torch.where(any_nz, p90 * s, torch.full_like(p90, float(np.float32(150.0 * s))))
        pairs.append(_clip_pair(torch.maximum(ten, floor(lo)), torch.minimum(top, floor(hi))))
    for s in _SENS:
        lo = torch.maximum(ten, floor(fma32(-0.5, std_g, mean_g) * s))
        hi = torch.minimum(top, floor(fma32(0.5, std_g, mean_g) * s))
        pairs.append(_clip_pair(lo, hi))
    for s in _SENS:
        lo = torch.maximum(ten, floor((otsu * 0.5 + mean_g * 0.5) * s))
        hi = torch.minimum(top, floor((otsu * 1.5 + mean_g * 1.0) * s))
        pairs.append(_clip_pair(lo, hi))
    return torch.stack([torch.stack(p, dim=-1) for p in pairs], dim=-2)


def edge_quality_scores(gray_u8: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """(20,) float32 scores of an (h, w) uint8 gray image's candidates: mean
    kept-component size x the std of gray at the edge pixels, -inf without a
    kept component.  The 20 hysteresis runs share one batched propagation."""
    mag, nms = gradient_and_nms(gray_u8, rgb=False)
    thr = thresholds.to(device=mag.device, dtype=torch.float32)
    n = thr.shape[0]
    edges, n_comp, n_edge = hysteresis_labeled(
        mag.expand(n, *mag.shape), nms.expand(n, *nms.shape), thr[:, 0], thr[:, 1]
    )
    avg_size = n_edge.float() / torch.clamp(n_comp, min=1).float()
    v = gray_u8.double().reshape(1, -1)
    m = edges.reshape(n, -1).double()
    cnt = torch.clamp(m.sum(dim=1).float(), min=1.0)
    mu = ((v * m).sum(dim=1).float()) / cnt
    mean_sq = ((v * v * m).sum(dim=1).float()) / cnt
    var = fma32(-mu, mu, mean_sq)
    contrast = COL.sqrt32(torch.clamp(var, min=0.0))
    return torch.where(n_comp > 0, avg_size * contrast, torch.full_like(avg_size, float("-inf")))


def _edge_analysis_gray(images: torch.Tensor):
    """(B, h, w, 3) uint8 -> (gray, cands (B, 20, 2)) on their device."""
    gray = COL.rgb_to_gray_cv2(images)
    return gray, adaptive_thresholds(gray)


def _best_pair(gray: torch.Tensor, cands: torch.Tensor):
    """The first best-scoring candidate of one gray image: (low, high)."""
    best = int(torch.argmax(edge_quality_scores(gray, cands)))
    pair = cands[best].cpu().numpy()
    return float(pair[0]), float(pair[1])


# ---------------------------------------------------------------------------
# Threshold selection: the host runtime, else the device graphs.
# ---------------------------------------------------------------------------


def _select_thresholds_native(image_rgb: np.ndarray):
    """(low, high) by native analysis and scoring, or None without the
    runtime."""
    out = native.canny_analysis(image_rgb)
    if out is None:
        return None
    gray, mag, nms, cands = out
    best = native.score_candidates(gray, mag, nms, cands)
    return float(cands[best][0]), float(cands[best][1])


def select_thresholds(image_rgb: np.ndarray, device=None):
    """Adaptive thresholds and the colour gradient: (low, high, mag (h, w)
    float32, nms (h, w) bool).  The host runtime's analysis and scoring, or
    without it the device analysis and scoring on `device` (the CPU when
    None)."""
    pair = _select_thresholds_native(image_rgb)
    if pair is not None:
        mag_c, nms_c = native.gradient_nms_rgb(image_rgb)
        return pair[0], pair[1], mag_c.astype(np.float32), nms_c
    img = torch.from_numpy(np.ascontiguousarray(image_rgb, np.uint8)).to(DEV.or_cpu(device))
    gray, cands = _edge_analysis_gray(img[None])
    low, high = _best_pair(gray[0], cands[0])
    mag_c, nms_c = gradient_and_nms(img, rgb=True)
    return low, high, mag_c.cpu().numpy(), nms_c.cpu().numpy()


def hysteresis_host(mag: np.ndarray, nms: np.ndarray, low, high):
    """Hysteresis by union-find over the weak graph: the 8-connected
    components of nms & (mag > low) that hold a strong pixel (mag > high).
    None without the runtime."""
    weak = nms & (mag > low)
    out = native.cc_label(weak, connectivity=8)
    if out is None:
        return None
    labels, num, _ = out
    if num == 0:
        return np.zeros(mag.shape, bool)
    strong = nms & (mag > high)
    keep = np.zeros(num + 1, bool)
    keep[labels[strong]] = True
    keep[0] = False
    return keep[labels]


def get_edge_map(image_rgb: np.ndarray, device=None):
    """Adaptive Canny: the best-scoring (low, high) of the gray image, then
    Canny on the RGB image.  Returns (edges (h, w) bool, (low, high))."""
    low, high, mag_c, nms_c = select_thresholds(image_rgb, device)
    edges = hysteresis_host(mag_c, nms_c, low, high)
    if edges is None:
        img = torch.from_numpy(np.ascontiguousarray(image_rgb, np.uint8)).to(DEV.or_cpu(device))
        edges = canny(img, low, high).cpu().numpy()
    return edges, (float(low), float(high))


def select_thresholds_pair(image_rgb: np.ndarray, device=None):
    """Adaptive (low, high) Canny thresholds for one (h, w, 3) uint8 image."""
    pair = _select_thresholds_native(image_rgb)
    if pair is not None:
        return pair
    img = torch.from_numpy(np.ascontiguousarray(image_rgb, np.uint8)).to(DEV.or_cpu(device))
    gray, cands = _edge_analysis_gray(img[None])
    return _best_pair(gray[0], cands[0])


def select_thresholds_many(images: np.ndarray, device=None, pool=None):
    """Adaptive thresholds of a (B, h, w, 3) uint8 batch: (lows (B,), highs
    (B,)) float32 arrays.  One host analysis and scoring per image, on
    `pool` (an executor; the calls release the interpreter lock) when given,
    else on the calling thread; or without the runtime one device analysis
    of the batch and a device scoring per image.

    Each host analysis is a `thresholds.image` span and adds one to the
    counter of its route, `thresholds.pool` or `thresholds.serial`."""
    if native.available():
        route = "thresholds.serial" if pool is None else "thresholds.pool"

        def one(im):
            with stage_timer("thresholds.image"):
                pair = _select_thresholds_native(im)
            timing.count(route)
            return pair

        if pool is None:
            pairs = [one(im) for im in images]
        else:
            pairs = list(pool.map(timing.carry(one), images))
    else:
        batch = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(DEV.or_cpu(device))
        gray, cands = _edge_analysis_gray(batch)
        pairs = [_best_pair(gray[k], cands[k]) for k in range(len(images))]
    return (np.asarray([p[0] for p in pairs], np.float32),
            np.asarray([p[1] for p in pairs], np.float32))


# ---------------------------------------------------------------------------
# The fast single-shot estimator (CodecConfig.fast_edges).
# ---------------------------------------------------------------------------


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
    mag = COL.sqrt32(gx * gx + gy * gy).flatten(1)
    nz = mag > 0
    glow = H.masked_percentile(mag, nz, 10.0)
    ghigh = H.masked_percentile(mag, nz, 90.0)
    return torch.floor((low + glow) / 2.0), torch.floor((high + ghigh) / 2.0)


def fast_thresholds_many(images: np.ndarray, device) -> tuple:
    """Fast threshold selection of a (B, h, w, 3) uint8 batch on `device`
    (the mode CodecConfig.fast_edges selects): (lows (B,), highs (B,))
    float32 arrays, without the 20-candidate sweep."""
    batch = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(device)
    lows, highs = SHARD.collect_all(_fast_blend_batch(batch))
    return lows.astype(np.float32), highs.astype(np.float32)
