"""Evaluation reports: batch Kodak sweep, summary stats, plots, CSV, HTML.

Per-image and summary reports, CSV export, PSNR / SSIM histograms, the
three-way PNG vs JPEG vs RHCCQ table, a summary CSV with an averages row, the
rate-distortion scatter, an HTML report and the 12-panel comparison figure.
Metrics run on `device` (None: CUDA); matplotlib is imported inside the
figure functions only.
"""

from __future__ import annotations

import html as _html
import os

import numpy as np

from roibasedimagecompression_torch.eval import harness
from roibasedimagecompression_torch.io import image_io
from roibasedimagecompression_torch.ops import metrics as M


def run_batch_evaluation(images_root, csv_path=None, plot_path=None, device=None) -> dict:
    """Batch evaluation of the `harness.kodak_pairs` layout under images_root."""
    pairs = harness.kodak_pairs(images_root)
    results = harness.evaluate_pairs(pairs, device)
    summary = harness.summarize(results)
    if csv_path:
        harness.to_csv(results, csv_path)
    if plot_path:
        save_metric_histograms(results, plot_path)
    return {"results": [r.as_dict() for r in results], "summary": summary}


def format_summary_report(summary: dict) -> str:
    """Text summary block of `harness.summarize`."""
    lines = ["=" * 60, "BATCH EVALUATION SUMMARY", "=" * 60]
    lines.append(f"Images evaluated: {summary.get('n_images', 0)}")
    for key in ("psnr", "ssim", "mse"):
        lines.append(
            f"{key.upper():5}: mean {summary[f'{key}_mean']:.4f}  "
            f"min {summary[f'{key}_min']:.4f}  max {summary[f'{key}_max']:.4f}  "
            f"std {summary[f'{key}_std']:.4f}"
        )
    lines.append(f"Mean rate: {summary['bpp_mean']:.3f} bpp")
    lines.append(f"Mean compression ratio: {summary['compression_ratio_mean']:.2f}:1")
    return "\n".join(lines)


def save_metric_histograms(results, path) -> None:
    """PSNR / SSIM histograms of a batch evaluation."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    psnr = [r.psnr for r in results]
    ssim = [r.ssim for r in results]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(psnr, bins=10, color="#4878a8", edgecolor="white")
    axes[0].set_title("PSNR (dB)")
    axes[1].hist(ssim, bins=10, color="#6aa84f", edgecolor="white")
    axes[1].set_title("SSIM")
    fig.suptitle("RHCCQ batch evaluation")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_region_grid(image_rgb: np.ndarray, regions: list, path, max_display: int = 12) -> None:
    """Grid of the extracted regions (`models/segment.py Region`), each crop
    masked to its region."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(len(regions), max_display)
    if n == 0:
        return
    cols = 4
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(14, 3.5 * rows), squeeze=False)
    for i, ax in enumerate(axes.ravel()):
        ax.axis("off")
        if i >= n:
            continue
        r = regions[i]
        minr, minc, maxr, maxc = r.bbox
        crop = image_rgb[minr:maxr, minc:maxc].copy()
        crop[~r.bbox_mask] = 0
        ax.imshow(crop)
        ax.set_title(f"{r.kind} region {i + 1}\narea {r.area:,} px", fontsize=9)
    fig.suptitle(f"{len(regions)} regions")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def difference_maps(original: np.ndarray, reconstructed: np.ndarray) -> dict:
    """Absolute, squared and luminance-weighted difference maps, each
    normalised to uint8."""
    of = original.astype(np.float64)
    rf = reconstructed.astype(np.float64)
    diff = np.abs(of - rf)

    def norm(x):
        m = x.max()
        return (x / m * 255.0).astype(np.uint8) if m > 0 else np.zeros(x.shape, np.uint8)

    weighted = (diff * np.array([0.299, 0.587, 0.114])).sum(axis=2)
    return {
        "absolute": norm(diff),
        "squared": norm((of - rf) ** 2),
        "weighted": norm(weighted),
    }


def compress_with_jpeg(image_path, out_path, quality: int = 85) -> dict:
    """Write the JPEG baseline of an image file at `quality`."""
    img = image_io.imread_rgb(image_path)
    data = image_io.jpeg_bytes(img, quality=quality)
    with open(out_path, "wb") as f:
        f.write(data)
    original = os.path.getsize(image_path)
    return {
        "original_bytes": original,
        "jpeg_bytes": len(data),
        "ratio": original / len(data),
        "quality": quality,
    }


def three_way_comparison(png_path, jpg_path, rhccq_path, device=None) -> dict:
    """PNG vs JPEG vs RHCCQ row: sizes, ratios, bpp, PSNR / SSIM / MSE."""
    original = image_io.imread_rgb(png_path)
    jpeg = image_io.imread_rgb(jpg_path)
    res = harness.evaluate_pair(png_path, rhccq_path, device=device)
    jm = M.quality_metrics(original, jpeg, device)
    pixels = original.shape[0] * original.shape[1]
    png_bytes = os.path.getsize(png_path)
    jpg_bytes = os.path.getsize(jpg_path)
    raw = pixels * 3
    return {
        "name": os.path.basename(str(png_path)),
        "png_bytes": png_bytes,
        "jpeg": {
            "bytes": jpg_bytes,
            "ratio": raw / jpg_bytes,
            "bpp": jpg_bytes * 8 / pixels,
            "psnr": jm["psnr"],
            "ssim": jm["ssim"],
            "mse": jm["mse"],
        },
        "rhccq": {
            "bytes": res.file_bytes,
            "ratio": res.compression_ratio,
            "bpp": res.bpp,
            "psnr": res.psnr,
            "ssim": res.ssim,
            "mse": res.mse,
        },
        "delta_psnr": res.psnr - jm["psnr"],
        "delta_ssim": res.ssim - jm["ssim"],
        "delta_bpp": res.bpp - jpg_bytes * 8 / pixels,
    }


def summary_csv(rows: list, path) -> None:
    """Comparison CSV of `three_way_comparison` rows with an averages row."""
    import csv

    flat = []
    for r in rows:
        flat.append(
            {
                "name": r["name"],
                "jpeg_bytes": r["jpeg"]["bytes"],
                "jpeg_bpp": r["jpeg"]["bpp"],
                "jpeg_psnr": r["jpeg"]["psnr"],
                "jpeg_ssim": r["jpeg"]["ssim"],
                "rhccq_bytes": r["rhccq"]["bytes"],
                "rhccq_bpp": r["rhccq"]["bpp"],
                "rhccq_psnr": r["rhccq"]["psnr"],
                "rhccq_ssim": r["rhccq"]["ssim"],
                "delta_psnr": r["delta_psnr"],
                "delta_ssim": r["delta_ssim"],
            }
        )
    avg = {"name": "AVERAGE"}
    for key in flat[0]:
        if key != "name":
            avg[key] = float(np.mean([row[key] for row in flat]))
    flat.append(avg)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(flat[0].keys()))
        writer.writeheader()
        writer.writerows(flat)


def rd_scatter(rows: list, path) -> None:
    """Rate-distortion scatter: bpp against PSNR for both codecs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.scatter(
        [r["jpeg"]["bpp"] for r in rows],
        [r["jpeg"]["psnr"] for r in rows],
        label="JPEG", color="#b8562c", alpha=0.8,
    )
    ax.scatter(
        [r["rhccq"]["bpp"] for r in rows],
        [r["rhccq"]["psnr"] for r in rows],
        label="RHCCQ", color="#4878a8", alpha=0.8,
    )
    ax.set_xlabel("Rate (bits per pixel)")
    ax.set_ylabel("PSNR (dB)")
    ax.legend()
    ax.set_title("Rate-distortion: JPEG vs RHCCQ")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def html_report(rows: list, path, title: str = "RHCCQ vs JPEG comparison") -> None:
    """Standalone HTML report of `three_way_comparison` rows."""
    cells = []
    for r in rows:
        cells.append(
            f"<tr><td>{_html.escape(str(r['name']))}</td>"
            f"<td>{r['jpeg']['bytes']:,}</td><td>{r['jpeg']['bpp']:.2f}</td>"
            f"<td>{r['jpeg']['psnr']:.2f}</td><td>{r['jpeg']['ssim']:.4f}</td>"
            f"<td>{r['rhccq']['bytes']:,}</td><td>{r['rhccq']['bpp']:.2f}</td>"
            f"<td>{r['rhccq']['psnr']:.2f}</td><td>{r['rhccq']['ssim']:.4f}</td>"
            f"<td>{r['delta_psnr']:+.2f}</td></tr>"
        )
    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
 body {{ font-family: sans-serif; margin: 2rem; }}
 table {{ border-collapse: collapse; }}
 th, td {{ border: 1px solid #ccc; padding: 0.35rem 0.6rem; text-align: right; }}
 th {{ background: #f0f0f0; }}
 td:first-child {{ text-align: left; }}
</style></head>
<body><h1>{_html.escape(title)}</h1>
<table><thead><tr><th>image</th>
<th>JPEG bytes</th><th>JPEG bpp</th><th>JPEG PSNR</th><th>JPEG SSIM</th>
<th>RHCCQ bytes</th><th>RHCCQ bpp</th><th>RHCCQ PSNR</th><th>RHCCQ SSIM</th>
<th>&Delta;PSNR</th></tr></thead>
<tbody>{''.join(cells)}</tbody></table></body></html>"""
    with open(path, "w") as f:
        f.write(doc)


def comparison_figure(original: np.ndarray, reconstructed: np.ndarray, path, device=None) -> dict:
    """The 12-panel quality-comparison figure: original, reconstruction,
    split-screen, three difference maps, error heatmap, error histogram,
    per-channel MSE bars, a metrics table, the SSIM map and a rating panel.

    Saves a PNG to `path`; returns the metrics dict used in the panels.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = M.quality_metrics(original, reconstructed, device)
    diffs = difference_maps(original, reconstructed)

    fig, axes = plt.subplots(3, 4, figsize=(20, 15))
    axes = axes.flatten()

    axes[0].imshow(original)
    axes[0].set_title(f"Original Image\n{original.shape[1]}x{original.shape[0]}")
    axes[1].imshow(reconstructed)
    axes[1].set_title("Reconstructed Image")

    h, w = original.shape[:2]
    side = np.concatenate([original, reconstructed], axis=1)
    axes[2].imshow(side)
    axes[2].axvline(x=w, color="red", linestyle="--", linewidth=2)
    axes[2].set_title("Side-by-side Comparison")

    axes[3].imshow(diffs["absolute"])
    axes[3].set_title("Absolute Difference")
    axes[4].imshow(diffs["squared"])
    axes[4].set_title("Squared Difference (Amplified)")
    axes[5].imshow(diffs["weighted"], cmap="hot")
    axes[5].set_title("Perceptual Difference (Hot)")
    axes[6].imshow(diffs["weighted"], cmap="jet")
    axes[6].set_title("Error Heatmap")

    error_flat = np.abs(
        original.astype(np.float64) - reconstructed.astype(np.float64)
    ).ravel()
    axes[7].hist(error_flat, bins=50, color="blue", alpha=0.7, edgecolor="black")
    axes[7].set_title("Error Distribution")
    axes[7].set_xlabel("Absolute Error")
    axes[7].set_ylabel("Frequency")
    axes[7].grid(True, alpha=0.3)

    mse_channels = [metrics["mse_r"], metrics["mse_g"], metrics["mse_b"]]
    axes[8].bar(range(3), mse_channels, color=["red", "green", "blue"], alpha=0.7)
    axes[8].set_title("MSE per Channel")
    axes[8].set_xticks(range(3))
    axes[8].set_xticklabels(["R", "G", "B"])
    axes[8].grid(True, alpha=0.3, axis="y")

    table = (
        "Quality Metrics:\n----------------\n"
        f"PSNR: {metrics['psnr']:.2f} dB\nSSIM: {metrics['ssim']:.3f}\n"
        f"MSE:  {metrics['mse']:.2f}\nRMSE: {metrics['rmse']:.2f}\n"
        f"MAE:  {metrics['mae']:.2f}\nMax Error: {metrics['max_error']:.2f}\n\n"
        "Channel MSE:\n"
        f"  Red:   {metrics['mse_r']:.2f}\n"
        f"  Green: {metrics['mse_g']:.2f}\n"
        f"  Blue:  {metrics['mse_b']:.2f}"
    )
    axes[9].text(
        0.1, 0.5, table, fontsize=10, verticalalignment="center",
        bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5),
    )

    smap = M.ssim_map(original, reconstructed, device=device)
    axes[10].imshow(smap, cmap="viridis", vmin=0, vmax=1)
    axes[10].set_title("SSIM Map\n(Structural Similarity)")

    psnr = metrics["psnr"]
    rating = (
        "Excellent" if psnr > 40 else "Good" if psnr > 30
        else "Fair" if psnr > 20 else "Poor"
    )
    ssim_v = metrics["ssim"]
    ssim_rating = (
        "Excellent" if ssim_v > 0.95 else "Good" if ssim_v > 0.85
        else "Fair" if ssim_v > 0.70 else "Poor"
    )
    assessment = (
        "Quality Assessment:\n-------------------\n"
        f"PSNR: {psnr:.1f} dB -> {rating}\n"
        f"SSIM: {ssim_v:.3f} -> {ssim_rating}\n\n"
        "Interpretation:\n"
        "- PSNR > 40 dB: Excellent\n- 30-40 dB: Good\n- 20-30 dB: Fair\n- < 20 dB: Poor\n\n"
        "- SSIM > 0.95: Excellent\n- 0.85-0.95: Good\n- 0.70-0.85: Fair\n- < 0.70: Poor"
    )
    axes[11].text(
        0.1, 0.5, assessment, fontsize=9, verticalalignment="center",
        bbox=dict(boxstyle="round", facecolor="lightgray", alpha=0.5),
    )

    for i, ax in enumerate(axes):
        if i not in (7, 8):
            ax.axis("off")
    fig.suptitle(
        "Image Quality Comparison: Original vs Reconstructed",
        fontsize=16, fontweight="bold",
    )
    fig.tight_layout()
    fig.savefig(path, dpi=72, bbox_inches="tight")
    plt.close(fig)
    return metrics
