"""Spline boundary compression (side capability).

Rebuilds encoder/interpolation/{spline,reconstruct}.py: a closed boundary
polyline is divided into arc-length sublists with overlap, each sublist keeps
its high-curvature key points and is fitted with a parametric B-spline; the
minimal storage is the rounded, deduplicated key-point matrix, reconstructed
through a periodic spline.

This module is deliberately host-side: it is not wired into the .rhccq
bitstream (boundaries are stored implicitly via merged index matrices,
SURVEY.md §2.4) and the FITPACK solves are tiny.  scipy is the natural host
backend, exactly as zlib is for the container.  It is a copy of the JAX
package's `models/spline.py`; the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import splev, splprep


def _close(coords: np.ndarray) -> np.ndarray:
    coords = np.asarray(coords, float)
    if not np.allclose(coords[0], coords[-1]):
        coords = np.vstack([coords, coords[0]])
    return coords


def divide_by_arc_length(coords: np.ndarray, num_sublists: int = 3):
    """Split a closed polyline into arc-length-equal sublists with 2-point
    overlaps (divide_shape_smart_fixed, spline.py:59-114)."""
    coords = _close(coords)
    seglen = np.linalg.norm(np.diff(coords, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seglen)])
    total = arc[-1]
    division = [0]
    for i in range(1, num_sublists):
        division.append(int(np.argmin(np.abs(arc - i * total / num_sublists))))
    division.append(len(coords) - 1)

    sublists = []
    for i in range(len(division) - 1):
        start, end = division[i], division[i + 1] + 1
        if i > 0:
            start = max(0, start - 2)
        if i < len(division) - 2:
            end = min(len(coords), end + 2)
        sublists.append(coords[start:end])
    return sublists, division


def _curvature(coords: np.ndarray) -> np.ndarray:
    """Turning angle at each interior point (spline.py:139-152)."""
    curv = np.zeros(len(coords))
    v1 = coords[1:-1] - coords[:-2]
    v2 = coords[2:] - coords[1:-1]
    n1 = np.linalg.norm(v1, axis=1)
    n2 = np.linalg.norm(v2, axis=1)
    ok = (n1 > 0) & (n2 > 0)
    cosang = np.clip(
        np.einsum("ij,ij->i", v1, v2) / np.maximum(n1 * n2, 1e-12), -1.0, 1.0
    )
    curv[1:-1] = np.where(ok, np.arccos(cosang), 0.0)
    return curv


def select_key_points(coords: np.ndarray, compression_ratio: float, boundary_sublist: bool):
    """First/last points plus the highest-curvature interior points
    (compress_sublist_with_continuity, spline.py:120-173)."""
    n = len(coords)
    if compression_ratio >= 1.0 or n <= 4:
        return np.arange(n)
    ratio = compression_ratio * (0.8 if boundary_sublist else 1.0)
    n_key = max(4, int(n * ratio))
    if n <= n_key:
        return np.arange(n)
    curv = _curvature(coords)
    keep = [0, n - 1]
    remaining = n_key - 2
    if remaining > 0:
        interior = np.argsort(curv[1:-1])[-remaining:][::-1] + 1
        keep.extend(interior.tolist())
    return np.array(sorted(set(keep)))


def fit_sublist(coords: np.ndarray, key_idx: np.ndarray):
    """Parametric spline fit through the key points; reconstructs len(coords)
    samples (spline.py:184-205: s = max(1, n_key*0.1), k = min(3, n_key-1))."""
    key = coords[key_idx]
    k = min(3, len(key) - 1)
    if k < 1:
        return coords.copy(), key
    smoothing = max(1.0, len(key) * 0.1)
    try:
        tck, _ = splprep([key[:, 0], key[:, 1]], s=smoothing, per=0, k=k)
        t = np.linspace(0, 1, len(coords))
        x, y = splev(t, tck)
        return np.column_stack([x, y]), key
    except Exception:
        # Linear fallback (reference degrades the same way, spline.py:220-222).
        t = np.linspace(0, len(key) - 1, len(coords))
        x = np.interp(t, np.arange(len(key)), key[:, 0])
        y = np.interp(t, np.arange(len(key)), key[:, 1])
        return np.column_stack([x, y]), key


def compress_shape(coords, num_sublists: int = 3, compression_ratio: float = 0.2):
    """Full boundary compression (compress_shape_divided_exact,
    spline.py:226-312).  Returns dict with per-sublist results, the combined
    reconstruction, and error metrics."""
    coords = _close(np.asarray(coords, float))
    sublists, _ = divide_by_arc_length(coords, num_sublists)

    results = []
    for i, sub in enumerate(sublists):
        boundary = i == 0 or i == len(sublists) - 1
        key_idx = select_key_points(sub, compression_ratio, boundary)
        recon, key = fit_sublist(sub, key_idx)
        err = float(np.mean(np.linalg.norm(recon - sub, axis=1)))
        results.append({"reconstructed": recon, "key_points": key, "mean_error": err})

    # Recombine, dropping 20% overlap at joins (spline.py:314-336).
    combined = []
    for i, r in enumerate(results):
        rec = r["reconstructed"]
        drop = int(len(rec) * 0.2)
        lo = drop // 2 if i > 0 else 0
        hi = len(rec) - (drop // 2 if i < len(results) - 1 else 0)
        combined.append(rec[lo:hi])
    combined = np.vstack(combined)

    total_keys = sum(len(r["key_points"]) for r in results)
    return {
        "sublist_results": results,
        "combined_reconstructed": combined,
        "overall_metrics": {
            "mean_error": float(np.mean([r["mean_error"] for r in results])),
            "total_original_points": len(coords),
            "total_key_points": total_keys,
            "num_sublists": len(results),
            "compression_ratio": compression_ratio,
        },
    }


def minimal_storage(result: dict, decimals: int = 3) -> np.ndarray:
    """Rounded + deduplicated key-point matrix (get_minimal_storage_with_
    rounding, spline.py:338-384)."""
    pts = np.vstack([r["key_points"] for r in result["sublist_results"]])
    pts = np.round(pts, decimals)
    _, idx = np.unique(pts, axis=0, return_index=True)
    return pts[np.sort(idx)]


def reconstruct_from_minimal(key_points: np.ndarray, num_points: int = 500) -> np.ndarray:
    """Closed-shape reconstruction via periodic spline
    (reconstruct.py:5-64)."""
    pts = np.asarray(key_points, float)
    if len(pts) < 4:
        return _close(pts)
    try:
        tck, _ = splprep([pts[:, 0], pts[:, 1]], s=0, per=1)
        t = np.linspace(0, 1, num_points)
        x, y = splev(t, tck)
        return np.column_stack([x, y])
    except Exception:
        t = np.linspace(0, len(pts), num_points) % len(pts)
        x = np.interp(t, np.arange(len(pts)), pts[:, 0], period=len(pts))
        y = np.interp(t, np.arange(len(pts)), pts[:, 1], period=len(pts))
        return np.column_stack([x, y])


def save_key_points(key_points: np.ndarray, path) -> None:
    """Persist as .npy or .csv (reconstruct.py:67-79)."""
    path = str(path)
    if path.endswith(".csv"):
        np.savetxt(path, key_points, delimiter=",", fmt="%.3f")
    else:
        np.save(path, key_points)


def load_key_points(path) -> np.ndarray:
    path = str(path)
    if path.endswith(".csv"):
        return np.loadtxt(path, delimiter=",")
    return np.load(path)
