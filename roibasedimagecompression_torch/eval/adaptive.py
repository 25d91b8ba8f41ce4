"""Adaptive quality metrics with outlier exclusion.

Per-pixel worst-channel error distribution, four outlier detectors (IQR
2.5x, z-score 3, 99th percentile, skew-adaptive), the first detector
excluding 0.1-10 % of pixels wins; PSNR / MSE reported with and without
outliers plus percentile-trimmed variants, and SSIM with outliers neutralised
to gray.  Host numpy but for SSIM, which runs on `device` (None: CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops import metrics as M
from roibasedimagecompression_torch.utils import device as DEV


def _ssim(a: np.ndarray, b: np.ndarray, dev) -> float:
    return float(M.ssim(torch.from_numpy(np.array(a)).to(dev), torch.from_numpy(np.array(b)).to(dev)))


def adaptive_quality_metrics(original: np.ndarray, reconstructed: np.ndarray,
                             device=None) -> dict:
    dev = DEV.resolve(device)
    of = original.astype(np.float32)
    rf = reconstructed.astype(np.float32)
    abs_err = np.abs(of - rf)
    max_err = abs_err.max(axis=2).ravel()

    stats = {
        "min": float(max_err.min()),
        "max": float(max_err.max()),
        "mean": float(max_err.mean()),
        "median": float(np.median(max_err)),
        "std": float(max_err.std()),
        "q75": float(np.percentile(max_err, 75)),
        "q90": float(np.percentile(max_err, 90)),
        "q95": float(np.percentile(max_err, 95)),
        "q99": float(np.percentile(max_err, 99)),
    }

    q1, q3 = np.percentile(max_err, 25), np.percentile(max_err, 75)
    thresholds = {
        "iqr": q3 + 2.5 * (q3 - q1),
        "zscore": stats["mean"] + 3.0 * stats["std"],
        "percentile": np.percentile(max_err, 99),
        "adaptive": (
            stats["median"] + 3.0 * stats["std"]
            if stats["mean"] > stats["median"] * 1.5
            else stats["mean"] + 2.5 * stats["std"]
        ),
    }
    masks = {name: max_err > thr for name, thr in thresholds.items()}

    best_method = None
    for name in ("iqr", "zscore", "percentile", "adaptive"):
        pct = masks[name].mean() * 100.0
        if 0.1 <= pct <= 10.0:
            best_method = name
            break
    if best_method is None:
        best_method = "adaptive"
    outlier_mask = masks[best_method]
    n_out = int(outlier_mask.sum())

    def mse_block(o, r):
        if len(o) == 0:
            return None
        mse = float(np.mean((o - r) ** 2))
        return {
            "psnr": 10 * np.log10(255 * 255 / mse) if mse > 0 else float("inf"),
            "mse": mse,
            "rmse": float(np.sqrt(mse)),
            "mae": float(np.mean(np.abs(o - r))),
            "max_error": float(np.max(np.abs(o - r))) if len(o) else 0.0,
            "pixel_count": int(len(o)),
        }

    out = {
        "error_distribution": stats,
        "outlier_detection": {
            "method": best_method,
            "threshold": float(thresholds[best_method]),
            "outlier_count": n_out,
            "outlier_percentage": float(n_out / len(max_err) * 100.0),
            "inlier_count": int(len(max_err) - n_out),
            "inlier_percentage": float(100.0 - n_out / len(max_err) * 100.0),
        },
        "all_pixels": mse_block(of.reshape(-1, 3), rf.reshape(-1, 3)),
    }

    if 0 < n_out < len(max_err):
        inl = ~outlier_mask
        out["without_outliers"] = mse_block(
            of.reshape(-1, 3)[inl], rf.reshape(-1, 3)[inl]
        )

    for pct in (99, 95, 90, 75):
        thr = np.percentile(max_err, pct)
        sel = max_err <= thr
        block = mse_block(of.reshape(-1, 3)[sel], rf.reshape(-1, 3)[sel])
        if block:
            block["max_error_included"] = float(thr)
            block["percentage"] = float(pct)
            out[f"percentile_{pct}"] = block

    ssim = {"full": _ssim(original, reconstructed, dev)}
    if 0 < n_out < len(max_err):
        h, w = original.shape[:2]
        mask2d = outlier_mask.reshape(h, w)
        om = original.copy()
        rm = reconstructed.copy()
        om[mask2d] = 128
        rm[mask2d] = 128
        ssim["without_outliers"] = _ssim(om, rm, dev)
    out["ssim"] = ssim

    hist, edges = np.histogram(max_err, bins=50)
    out["error_histogram"] = {"bins": hist.tolist(), "bin_edges": edges.tolist()}
    return out


def format_adaptive_report(metrics: dict, original_shape: tuple) -> str:
    """Human-readable adaptive-metrics report."""
    h, w = original_shape[:2]
    lines = []
    add = lines.append
    add("=" * 70)
    add("ADAPTIVE QUALITY METRICS WITH OUTLIER DETECTION")
    add("=" * 70)

    ed = metrics["error_distribution"]
    add("")
    add("ERROR DISTRIBUTION ANALYSIS:")
    add(f"   Total pixels: {h * w:,}")
    add(f"   Min error:    {ed['min']:8.2f}")
    add(f"   Max error:    {ed['max']:8.2f}  <- LIKELY OUTLIERS")
    add(f"   Mean error:   {ed['mean']:8.2f}")
    add(f"   Median error: {ed['median']:8.2f}")
    add(f"   Std dev:      {ed['std']:8.2f}")
    add(f"   75th %ile:    {ed['q75']:8.2f}")
    add(f"   90th %ile:    {ed['q90']:8.2f}")
    add(f"   95th %ile:    {ed['q95']:8.2f}")
    add(f"   99th %ile:    {ed['q99']:8.2f}")

    od = metrics["outlier_detection"]
    add("")
    add(f"OUTLIER DETECTION ({od['method'].upper()}):")
    add(f"   Threshold:    {od['threshold']:8.2f}")
    add(
        f"   Outliers:     {od['outlier_count']:8,} pixels"
        f" ({od['outlier_percentage']:.2f}%)"
    )
    add(
        f"   Inliers:      {od['inlier_count']:8,} pixels"
        f" ({od['inlier_percentage']:.2f}%)"
    )

    add("")
    add("METRICS COMPARISON:")
    allp = metrics["all_pixels"]
    add(f"   ALL PIXELS ({allp['pixel_count']:,}):")
    add(f"     PSNR:  {allp['psnr']:8.2f} dB")
    add(f"     MSE:   {allp['mse']:8.2f}")
    add(f"     MAE:   {allp['mae']:8.2f}")

    if "without_outliers" in metrics:
        wo = metrics["without_outliers"]
        improvement = wo["psnr"] - allp["psnr"]
        add("")
        add(f"   WITHOUT OUTLIERS ({wo['pixel_count']:,}):")
        add(f"     PSNR:  {wo['psnr']:8.2f} dB  (+{improvement:.2f} dB)")
        add(f"     MSE:   {wo['mse']:8.2f}  ({wo['mse'] / allp['mse'] * 100:.1f}% of original)")
        add(f"     MAE:   {wo['mae']:8.2f}  ({wo['mae'] / allp['mae'] * 100:.1f}% of original)")
        add(f"     Max:   {wo['max_error']:8.2f}")

    add("")
    add("PERCENTILE METRICS:")
    for pct in (99, 95, 90, 75):
        key = f"percentile_{pct}"
        if key in metrics:
            pm = metrics[key]
            add(f"   Top {100 - pct}% excluded ({pm['pixel_count']:,} pixels):")
            add(f"     PSNR: {pm['psnr']:8.2f} dB")

    if "ssim" in metrics:
        add("")
        add("STRUCTURAL SIMILARITY (SSIM):")
        add(f"   Full image:      {metrics['ssim'].get('full', 0):.4f}")
        if "without_outliers" in metrics["ssim"]:
            add(f"   Without outliers: {metrics['ssim']['without_outliers']:.4f}")

    add("=" * 70)
    return "\n".join(lines)
