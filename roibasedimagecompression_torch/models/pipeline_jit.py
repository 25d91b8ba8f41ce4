"""The encoder's fused device core: edges, ROI seed, SLIC and palette
clustering of whole images with static shapes.

The counterpart of the JAX package's `models/pipeline_jit.py` (one jitted
XLA computation there): the compile-check unit of `entry()`,
the sharded batch analysis and the multi-device dry run.  Stages, each on the
images' device:

  adaptive Canny threshold selection (20 candidates scored, the first best
  kept) -> final RGB Canny -> edge density and the automatic ROI threshold
  -> SLIC over a regular centre grid (kernel 1 assigns) -> the sorted unique
  packed palette -> eps-graph palette clustering at the quality preset
  (kernel 2 on CUDA, its plain sweep on the CPU).

Every output equals the jitted JAX function's.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch.ops import canny as CANNY
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import hist as H
from roibasedimagecompression_torch.ops import slic as SLIC
from roibasedimagecompression_torch.ops import unique as U
from roibasedimagecompression_torch.ops.cuda import epscc as EPS
from roibasedimagecompression_torch.utils import device as DEV

OUTPUTS = ("edges", "roi_seed", "segments", "palette", "palette_count", "palette_clusters",
           "canny_low", "canny_high", "inverse")


def _grid_centers(h: int, w: int, n_side: int) -> np.ndarray:
    """Regular n_side x n_side grid of initial SLIC centres, (n_side^2, 2)
    int64 (y, x): float32 cell centres rounded half to even and clipped, as
    XLA folds them."""
    ys = (np.arange(n_side, dtype=np.float32) + np.float32(0.5)) * np.float32(h / n_side)
    xs = (np.arange(n_side, dtype=np.float32) + np.float32(0.5)) * np.float32(w / n_side)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    cy = np.clip(np.rint(yy.reshape(-1)).astype(np.int64), 0, h - 1)
    cx = np.clip(np.rint(xx.reshape(-1)).astype(np.int64), 0, w - 1)
    return np.stack([cy, cx], axis=1)


def batched_analysis_step(images, n_centers_side: int = 8, palette_cap: int = 4096,
                          quality: float = 20.0, device=None) -> dict:
    """Device encoder core over a (B, h, w, 3) uint8 batch (numpy or a
    tensor); returns a dict of tensors with a leading batch axis on `device`
    (CUDA when None, and then it raises without a card; "cpu" for the CPU)."""
    dev = DEV.resolve(device)
    x = torch.as_tensor(images if torch.is_tensor(images) else np.asarray(images),
                        dtype=torch.uint8).to(dev)
    b, h, w, _ = x.shape

    # Adaptive Canny: score all 20 threshold candidates, keep the first best.
    gray = COL.rgb_to_gray_cv2(x)
    cands = CANNY.adaptive_thresholds(gray)  # (B, 20, 2)
    scores = torch.stack([CANNY.edge_quality_scores(gray[k], cands[k]) for k in range(b)])
    best = torch.argmax(scores, dim=1)
    pair = cands[torch.arange(b, device=dev), best]
    low, high = pair[:, 0], pair[:, 1]
    mag, nms = CANNY.gradient_and_nms(x, rgb=True)
    edges = CANNY.hysteresis(mag, nms, low, high)

    # Edge density and the automatic threshold; XLA divides by 100 as a
    # product with float32(0.01).
    density = torch.stack([CONV.box_density(edges[k], 3) for k in range(b)])
    thr = torch.stack([H.masked_mean(density[k], edges[k]) for k in range(b)])
    roi_seed = edges & (density > (thr * float(np.float32(0.01)))[:, None, None])

    # SLIC over the full frame on a regular grid (the JAX package's chunk,
    # min(16384, h * w), is the one `_slic_core_batch` takes).
    n_centers = n_centers_side * n_centers_side
    centers = torch.from_numpy(_grid_centers(h, w, n_centers_side)).to(dev)
    step = torch.full((b,), float(np.float32((h * w / n_centers) ** 0.5)), dtype=torch.float32, device=dev)
    segments = SLIC._slic_core_batch(
        x, torch.ones((b, h, w), dtype=torch.bool, device=dev),
        centers[None].expand(b, n_centers, 2).contiguous(),
        torch.ones((b, n_centers), dtype=torch.bool, device=dev), step,
        iters=10, compactness=10.0, sigma=1.0,
    )

    # Palette extraction and eps clustering at the quality preset.
    flat = x.reshape(b, h * w, 3).to(torch.int32)
    packed = (flat[..., 0] << 16) | (flat[..., 1] << 8) | flat[..., 2]
    values, counts, inverse = [], [], []
    for k in range(b):
        v, c, inv = U.unique_packed_padded(packed[k], palette_cap)
        values.append(v)
        counts.append(min(c, palette_cap))
        inverse.append(inv.to(torch.int32))
    values = torch.stack(values)
    count = torch.tensor(counts, dtype=torch.int32, device=dev)
    palette = torch.stack([(values >> 16) & 0xFF, (values >> 8) & 0xFF, values & 0xFF], dim=-1).float()
    valid = torch.arange(palette_cap, device=dev)[None, :] < count[:, None].long()
    eps = np.float32(cfg.clustering_params(1, quality).eps)
    eps2 = torch.full((b,), float(eps * eps), dtype=torch.float32, device=dev)
    groups = torch.zeros((b, palette_cap), dtype=torch.int32, device=dev)
    sweep = EPS.eps_sweep if dev.type == "cuda" else EPS.eps_sweep_ref
    labels, _ = EPS.eps_components_rows(palette.contiguous(), valid, groups, eps2, sweep=sweep)
    return {
        "edges": edges,
        "roi_seed": roi_seed,
        "segments": segments,
        "palette": palette,
        "palette_count": count,
        "palette_clusters": labels,
        "canny_low": low,
        "canny_high": high,
        "inverse": torch.stack(inverse),
    }


def analysis_step(image_rgb, n_centers_side: int = 8, palette_cap: int = 4096,
                  quality: float = 20.0, device=None) -> dict:
    """Device encoder core for one (h, w, 3) uint8 image: the dict of
    `batched_analysis_step` without the batch axis."""
    x = image_rgb if torch.is_tensor(image_rgb) else torch.as_tensor(np.asarray(image_rgb, np.uint8))
    out = batched_analysis_step(x[None], n_centers_side=n_centers_side, palette_cap=palette_cap,
                                quality=quality, device=device)
    return {k: v[0] for k, v in out.items()}
