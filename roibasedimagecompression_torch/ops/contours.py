"""Iso-contour extraction (marching squares) for binary masks.

A host copy of the JAX package's `ops/contours.py` (numpy only; the port
imports nothing of that package): skimage.measure.find_contours(level=0.5)
for boolean masks, and the per-segment boundary descriptors built on it.
For a binary mask at level 0.5 every crossing lands on an edge midpoint,
matching skimage's interpolated coordinates.
"""

from __future__ import annotations

import numpy as np


def _cell_segments(mask: np.ndarray):
    """Yield line segments ((r0, c0), (r1, c1)) in half-pixel units (x2)."""
    m = mask.astype(bool)
    tl = m[:-1, :-1]
    tr = m[:-1, 1:]
    bl = m[1:, :-1]
    br = m[1:, 1:]

    rows, cols = np.nonzero(tl | tr | bl | br)
    segments = []
    for r, c in zip(rows, cols):
        a, b, d, e = tl[r, c], tr[r, c], br[r, c], bl[r, c]
        # Edge midpoints in doubled coordinates.
        top = (2 * r, 2 * c + 1)
        right = (2 * r + 1, 2 * c + 2)
        bottom = (2 * r + 2, 2 * c + 1)
        left = (2 * r + 1, 2 * c)
        crossings = []
        if a != b:
            crossings.append(("t", top))
        if b != d:
            crossings.append(("r", right))
        if e != d:
            crossings.append(("b", bottom))
        if a != e:
            crossings.append(("l", left))
        if len(crossings) == 2:
            segments.append((crossings[0][1], crossings[1][1]))
        elif len(crossings) == 4:
            # Saddle: resolve with the center treated as low (skimage's
            # default 'low' fully-connected-high convention inverted).
            if a and d:  # high on main diagonal
                segments.append((top, left))
                segments.append((bottom, right))
            else:
                segments.append((top, right))
                segments.append((bottom, left))
    return segments


def find_contours(mask: np.ndarray) -> list:
    """All contours of a binary mask as float (row, col) coordinate arrays.

    The mask is zero-padded so border-touching regions produce closed
    contours (skimage behavior for fully-surrounded level sets).
    """
    padded = np.zeros((mask.shape[0] + 2, mask.shape[1] + 2), bool)
    padded[1:-1, 1:-1] = mask.astype(bool)
    segments = _cell_segments(padded)
    if not segments:
        return []

    # Chain segments into paths via endpoint adjacency.
    adj: dict = {}
    for seg in segments:
        a, b = seg
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)

    visited = set()
    contours = []
    for seg in segments:
        start = seg[0]
        if (seg[0], seg[1]) in visited or (seg[1], seg[0]) in visited:
            continue
        path = [start]
        prev, cur = None, start
        while True:
            nbrs = adj[cur]
            nxt = None
            for n in nbrs:
                edge = (cur, n)
                if edge not in visited and (n, cur) not in visited:
                    nxt = n
                    break
            if nxt is None:
                break
            visited.add((cur, nxt))
            visited.add((nxt, cur))
            path.append(nxt)
            prev, cur = cur, nxt
            if cur == start:
                break
        # Convert doubled coords back to float (row, col), minus padding.
        arr = np.asarray(path, float) / 2.0 - 1.0
        contours.append(arr)
    return contours


def segment_boundaries(segments_map: np.ndarray, bbox_mask: np.ndarray) -> list:
    """Boundary descriptors for every SLIC segment.

    extract_slic_segment_boundaries (slic.py:143-214): per segment id the
    longest contour, with a synthetic half-pixel square for sub-2x2 segments.
    """
    out = []
    ids = np.unique(segments_map)
    ids = ids[ids != 0]
    for seg_id in ids:
        seg_mask = (segments_map == seg_id) & bbox_mask
        area = int(seg_mask.sum())
        if area == 0:
            continue
        rows, cols = seg_mask.shape
        if rows < 2 or cols < 2:
            ys, xs = np.nonzero(seg_mask)
            y, x = float(ys[0]), float(xs[0])
            coords = [
                (y - 0.5, x - 0.5), (y - 0.5, x + 0.5),
                (y + 0.5, x + 0.5), (y + 0.5, x - 0.5),
            ]
            out.append(
                {
                    "segment_id": int(seg_id),
                    "boundary_coords": coords,
                    "area": area,
                    "num_points": len(coords),
                    "note": "tiny_segment",
                }
            )
            continue
        contours = find_contours(seg_mask)
        if not contours:
            continue
        main = max(contours, key=len)
        coords = [tuple(p) for p in main]
        out.append(
            {
                "segment_id": int(seg_id),
                "boundary_coords": coords,
                "area": area,
                "num_points": len(coords),
                "note": "normal_segment",
            }
        )
    return out
