"""Spline boundary-codec visualization & analysis surface.

Equivalent of the reference's interpolation visualization module
(encoder/interpolation/visualization.py:5-323): a text analysis of a divided
compression result plus the figure set — divided-compression panels,
minimal-storage panels (key points / reconstruction / storage bars / error
curve), overlay comparison, and the quality-metrics dashboard.

Figures save to files (headless library; the reference called plt.show from
its notebook-era scripts).  All error conventions follow the reference:
per-point euclidean error against an index-aligned original, mean-of-sublists
for the divided result.  A copy of the JAX package's `models/spline_viz.py`:
the figure functions need matplotlib and raise ImportError without it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _closed(coords: np.ndarray) -> np.ndarray:
    coords = np.asarray(coords, float)
    if not np.allclose(coords[0], coords[-1]):
        coords = np.vstack([coords, coords[0]])
    return coords


def _aligned_errors(original: np.ndarray, reconstructed: np.ndarray) -> np.ndarray:
    """Per-point euclidean error, resampling the shorter curve by index when
    lengths differ (visualization.py compares index-aligned arrays; the
    codec's reconstruction density is a free parameter here)."""
    original = np.asarray(original, float)
    reconstructed = np.asarray(reconstructed, float)
    n = min(len(original), len(reconstructed))
    if len(original) != len(reconstructed):
        oi = np.linspace(0, len(original) - 1, n).round().astype(int)
        ri = np.linspace(0, len(reconstructed) - 1, n).round().astype(int)
        original, reconstructed = original[oi], reconstructed[ri]
    return np.sqrt(((reconstructed - original) ** 2).sum(axis=1))


def compression_analysis(result: dict) -> str:
    """Text report of a compress_shape result (the library form of
    print_divided_compression_analysis, visualization.py:5-35)."""
    if not result:
        return "no results to analyze"
    o = result["overall_metrics"]
    lines = [
        "DIVIDED COMPRESSION ANALYSIS",
        f"  sublists: {o['num_sublists']}",
        f"  compression ratio: {o['compression_ratio']:.1%}",
        f"  original points: {o['total_original_points']}",
        f"  key points: {o['total_key_points']}",
        f"  mean reconstruction error: {o['mean_error']:.6f}",
        "  per-sublist:",
    ]
    for i, sub in enumerate(result["sublist_results"]):
        lines.append(
            f"    {i + 1}: {len(sub['reconstructed'])} pts -> "
            f"{len(sub['key_points'])} keys, error {sub['mean_error']:.6f}"
        )
    return "\n".join(lines)


def plot_divided_compression(coordinates, result: dict, path) -> None:
    """2x2 figure: original / combined reconstruction / per-sublist key
    points / overlay (visualize_divided_compression, visualization.py:37-87)."""
    plt = _plt()
    original = _closed(coordinates)
    combined = result["combined_reconstructed"]
    o = result["overall_metrics"]

    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(14, 11))
    ax1.plot(original[:, 0], original[:, 1], "b-", lw=2, label="original")
    ax1.set_title(f"Original shape\n{o['total_original_points']} points")
    ax2.plot(combined[:, 0], combined[:, 1], "r-", lw=2, label="reconstructed")
    ax2.set_title(
        f"Combined reconstruction\n{o['total_key_points']} key points, "
        f"error {o['mean_error']:.4f}"
    )
    ax3.plot(original[:, 0], original[:, 1], "k-", alpha=0.3, lw=1, label="original")
    colors = ["red", "green", "blue", "orange", "purple"]
    for i, sub in enumerate(result["sublist_results"]):
        kp = np.asarray(sub["key_points"])
        ax3.plot(
            kp[:, 0], kp[:, 1], "o", color=colors[i % len(colors)], ms=5,
            mfc="none", mew=1.5, label=f"sublist {i + 1}",
        )
    ax3.set_title(f"Key points by sublist\n{o['num_sublists']} sublists")
    ax4.plot(original[:, 0], original[:, 1], "b-", lw=2, alpha=0.7, label="original")
    ax4.plot(combined[:, 0], combined[:, 1], "r--", lw=2, label="reconstructed")
    ax4.set_title("Overlay comparison")
    for ax in (ax1, ax2, ax3, ax4):
        ax.set_aspect("equal")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_minimal_storage(original, key_points, reconstructed, path) -> None:
    """2x2 figure: key points over the original / reconstruction / storage
    bars / per-point error (visualize_minimal_storage_results,
    visualization.py:89-143)."""
    plt = _plt()
    original = np.asarray(original, float)
    key_points = np.asarray(key_points, float)
    reconstructed = np.asarray(reconstructed, float)

    orig_bytes = original.size * 8
    comp_bytes = key_points.size * 8
    errors = _aligned_errors(original, reconstructed)

    fig, axes = plt.subplots(2, 2, figsize=(14, 11))
    axes[0, 0].plot(original[:, 0], original[:, 1], "b-", alpha=0.7, lw=2, label="original")
    axes[0, 0].plot(key_points[:, 0], key_points[:, 1], "ro", ms=4, label="key points")
    axes[0, 0].set_title(f"Original vs compressed\n({len(key_points)} key points)")
    axes[0, 1].plot(original[:, 0], original[:, 1], "b-", alpha=0.7, lw=2, label="original")
    axes[0, 1].plot(
        reconstructed[:, 0], reconstructed[:, 1], "g--", alpha=0.8, lw=2,
        label="reconstructed",
    )
    axes[0, 1].set_title("Original vs reconstructed")
    for ax in (axes[0, 0], axes[0, 1]):
        ax.set_aspect("equal")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)

    labels = [f"original\n{orig_bytes:,} B", f"compressed\n{comp_bytes:,} B"]
    axes[1, 0].bar(labels, [orig_bytes, comp_bytes], color=["lightcoral", "lightgreen"])
    axes[1, 0].set_title("Storage comparison")
    axes[1, 0].set_ylabel("bytes")

    axes[1, 1].plot(errors, "r-", alpha=0.7)
    axes[1, 1].axhline(
        errors.mean(), color="blue", ls="--", label=f"mean {errors.mean():.6f}"
    )
    axes[1, 1].set_title("Reconstruction error per point")
    axes[1, 1].set_xlabel("point index")
    axes[1, 1].set_ylim(bottom=0)
    axes[1, 1].legend(fontsize=8)
    axes[1, 1].grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_reconstruction_overlay(original, key_points, reconstructed, path) -> None:
    """Single overlay of original boundary, key points, and reconstruction
    (visualize_reconstruction_overlay, visualization.py:245-265)."""
    plt = _plt()
    original = np.asarray(original, float)
    key_points = np.asarray(key_points, float)
    reconstructed = np.asarray(reconstructed, float)
    fig, ax = plt.subplots(figsize=(10, 9))
    ax.plot(original[:, 0], original[:, 1], "b-", lw=3, alpha=0.5, label="original")
    ax.plot(
        key_points[:, 0], key_points[:, 1], "ro", ms=6,
        label=f"key points ({len(key_points)})",
    )
    ax.plot(
        reconstructed[:, 0], reconstructed[:, 1], "g--", lw=2, alpha=0.8,
        label="reconstructed",
    )
    ax.set_title(
        f"Boundary reconstruction\n{len(original)} -> {len(key_points)} -> "
        f"{len(reconstructed)} points"
    )
    ax.legend()
    ax.grid(True, alpha=0.3)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def quality_metrics(original, reconstructed) -> dict:
    """Reconstruction quality summary (the numbers behind
    visualize_quality_metrics, visualization.py:267-323)."""
    errors = _aligned_errors(original, reconstructed)
    return {
        "mean_error": float(errors.mean()),
        "max_error": float(errors.max()),
        "std_error": float(errors.std()),
        "p95_error": float(np.percentile(errors, 95)),
        "points_above_1e-3": int((errors > 1e-3).sum()),
        "compression_ratio": len(reconstructed) / max(len(original), 1),
    }


def plot_quality_metrics(original, reconstructed, path) -> dict:
    """2x2 dashboard: error histogram / cumulative error / error along the
    boundary / text summary (visualize_quality_metrics).  Returns the
    quality_metrics dict."""
    plt = _plt()
    errors = _aligned_errors(original, reconstructed)
    m = quality_metrics(original, reconstructed)

    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(14, 11))
    ax1.hist(errors, bins=50, alpha=0.7, color="red", edgecolor="black")
    ax1.axvline(m["mean_error"], color="blue", ls="--", label=f"mean {m['mean_error']:.6f}")
    ax1.set_title("Error distribution")
    ax1.legend(fontsize=8)
    ax2.plot(np.cumsum(errors), "purple", lw=2)
    ax2.set_title("Cumulative reconstruction error")
    ax3.plot(errors, "orange", lw=1)
    ax3.axhline(m["mean_error"], color="red", ls="--", label=f"mean {m['mean_error']:.6f}")
    ax3.set_title("Error along boundary")
    ax3.legend(fontsize=8)
    for ax in (ax1, ax2, ax3):
        ax.grid(True, alpha=0.3)
    ax4.axis("off")
    text = "\n".join(f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}" for k, v in m.items())
    ax4.text(
        0.1, 0.9, text, transform=ax4.transAxes, fontsize=12, va="top",
        bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5),
    )
    ax4.set_title("Quality metrics summary")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return m
