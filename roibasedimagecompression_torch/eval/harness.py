"""Evaluation harness: Kodak sweep, bpp accounting, JPEG baseline.

Decodes each (PNG, .rhccq) pair, scores it with PSNR / SSIM / MSE on the
device (`ops/metrics.py`), and reports per-image rows, summary statistics and
an optional CSV.  bpp is file bytes * 8 / pixels; the compression ratio is
raw RGB bytes / file bytes.  Every scoring function takes `device` (None:
CUDA, "cpu" for the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

import numpy as np

from roibasedimagecompression_torch.io import container, image_io
from roibasedimagecompression_torch.ops import metrics as M


@dataclasses.dataclass
class PairResult:
    name: str
    psnr: float
    ssim: float
    mse: float
    file_bytes: int
    pixels: int
    n_colors: int

    @property
    def bpp(self) -> float:
        return self.file_bytes * 8.0 / self.pixels

    @property
    def compression_ratio(self) -> float:
        return (self.pixels * 3.0) / self.file_bytes

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "psnr": self.psnr,
            "ssim": self.ssim,
            "mse": self.mse,
            "file_bytes": self.file_bytes,
            "pixels": self.pixels,
            "n_colors": self.n_colors,
            "bpp": self.bpp,
            "compression_ratio": self.compression_ratio,
        }


def evaluate_pair(png_path, rhccq_path, name: str | None = None, device=None) -> PairResult:
    """Decode one .rhccq and score it against its PNG original."""
    original = image_io.imread_rgb(png_path)
    payload = container.load(rhccq_path)
    recon = payload.to_rgb()
    if recon.shape != original.shape:
        raise ValueError(
            f"shape mismatch: {original.shape} vs {recon.shape} for {rhccq_path}"
        )
    q = M.quality_metrics(original, recon, device)
    return PairResult(
        name=name or os.path.basename(str(rhccq_path)),
        psnr=q["psnr"],
        ssim=q["ssim"],
        mse=q["mse"],
        file_bytes=os.path.getsize(rhccq_path),
        pixels=original.shape[0] * original.shape[1],
        n_colors=payload.n_colors,
    )


def kodak_pairs(images_root) -> list:
    """The benchmark layout: images/png/{i}.png against
    images/rhccq_20_10/compressed_{i}.rhccq for i in 1..24."""
    pairs = []
    for i in range(1, 25):
        png = os.path.join(images_root, "png", f"{i}.png")
        rq = os.path.join(images_root, "rhccq_20_10", f"compressed_{i}.rhccq")
        if os.path.exists(png) and os.path.exists(rq):
            pairs.append((png, rq, str(i)))
    return pairs


def evaluate_pairs(pairs: Iterable[tuple], device=None) -> list:
    return [evaluate_pair(p, r, n, device) for p, r, n in pairs]


def summarize(results: Sequence[PairResult]) -> dict:
    """Summary statistics: mean, min, max and std of PSNR / SSIM / MSE, mean
    bpp and mean compression ratio."""
    if not results:
        return {}
    bpp = np.array([r.bpp for r in results])
    out = {"n_images": len(results)}
    for key in ("psnr", "ssim", "mse"):
        v = np.array([getattr(r, key) for r in results], dtype=np.float64)
        out[f"{key}_mean"] = float(v.mean())
        out[f"{key}_min"] = float(v.min())
        out[f"{key}_max"] = float(v.max())
        out[f"{key}_std"] = float(v.std())
    out["bpp_mean"] = float(bpp.mean())
    out["compression_ratio_mean"] = float(np.mean([r.compression_ratio for r in results]))
    return out


def to_csv(results: Sequence[PairResult], path) -> None:
    """One CSV row per result (the as_dict fields)."""
    import csv

    rows = [r.as_dict() for r in results]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def jpeg_at_matched_size(original: np.ndarray, target_bytes: int) -> tuple:
    """The JPEG quality whose file size best matches target_bytes, by binary
    search over 1..100: (jpeg_rgb, jpeg_bytes, quality)."""
    lo, hi = 1, 100
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        data = image_io.jpeg_bytes(original, quality=mid)
        diff = len(data) - target_bytes
        if best is None or abs(diff) < abs(best[2]):
            best = (mid, data, diff)
        if diff < 0:
            lo = mid + 1
        else:
            hi = mid - 1
    quality, data, _ = best
    return image_io.decode_jpeg(data), data, quality


def compare_vs_jpeg(png_path, rhccq_path, device=None) -> dict:
    """PNG vs rate-matched JPEG vs RHCCQ comparison row."""
    original = image_io.imread_rgb(png_path)
    res = evaluate_pair(png_path, rhccq_path, device=device)
    jpeg_rgb, jpeg_data, jq = jpeg_at_matched_size(original, res.file_bytes)
    jm = M.quality_metrics(original, jpeg_rgb, device)
    return {
        "rhccq": res.as_dict(),
        "jpeg": {
            "quality": jq,
            "psnr": jm["psnr"],
            "ssim": jm["ssim"],
            "mse": jm["mse"],
            "file_bytes": len(jpeg_data),
            "bpp": len(jpeg_data) * 8.0 / res.pixels,
        },
        "delta_psnr": res.psnr - jm["psnr"],
        "delta_ssim": res.ssim - jm["ssim"],
    }
