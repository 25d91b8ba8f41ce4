"""Secondary ROI capabilities: pixel-connection strategies, legacy thinness
scoring, hierarchical contextual cleaning, watershed segmentation.

The counterpart of the JAX package's `models/roi_extras.py` (reference
components outside the main encode path: the connect_nearby_pixels strategy
family, thin-structure scoring v1, contextual region cleaning, and the
watershed alternative to SLIC).  Morphology, the distance transform, the
thinning, the box filter and the label adoption run on `device` (CUDA when
None, as the entry points do; pass "cpu" for the CPU); the hull, contour and
Voronoi geometry and the marker search stay on the host, as in the JAX
package.  Masks and labels equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from roibasedimagecompression_torch.models.roi import _dev, remove_small_regions
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import contours as CONT
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import distance as DIST
from roibasedimagecompression_torch.ops import morphology as M
from roibasedimagecompression_torch.ops import thinning as THIN
from roibasedimagecompression_torch.utils import device as DEV


def connect_by_dilation(mask: np.ndarray, connection_distance: int, min_region_size: int,
                        device=None) -> np.ndarray:
    """Dilate-then-erode connection after small-region cleanup."""
    dev = DEV.resolve(device)
    cleaned = remove_small_regions(mask, min_region_size, dev)
    se = M.ellipse_kernel(connection_distance * 2 + 1)
    return M.erode(M.dilate(_dev(cleaned, dev), se), se).cpu().numpy()


def connect_by_closing(mask: np.ndarray, connection_distance: int, device=None) -> np.ndarray:
    """Ellipse closing (the strategy the main pipeline uses)."""
    se = M.ellipse_kernel(connection_distance * 2 + 1)
    return M.close(_dev(np.asarray(mask, bool), DEV.resolve(device)), se).cpu().numpy()


def connect_by_skeleton(mask: np.ndarray, connection_distance: int, device=None) -> np.ndarray:
    """Skeleton bridging: thin the within-distance zone of the background's
    distance transform and union it in."""
    dev = DEV.resolve(device)
    mask = np.asarray(mask, bool)
    dist = DIST.distance_transform_l2(_dev(~mask, dev))
    skeleton = THIN.zhang_suen_thinning(dist <= connection_distance).cpu().numpy()
    return mask | skeleton


def connect_by_region_growing(mask: np.ndarray, connection_distance: int, min_region_size: int,
                              device=None) -> np.ndarray:
    """Grow every component by the connection distance."""
    dev = DEV.resolve(device)
    cleaned = remove_small_regions(mask, min_region_size, dev)
    se = M.ellipse_kernel(connection_distance * 2 + 1)
    return M.dilate(_dev(cleaned, dev), se).cpu().numpy()


def connect_by_voronoi(mask: np.ndarray, connection_distance: int, min_region_size: int,
                       device=None) -> np.ndarray:
    """Voronoi-polygon connection: fill Voronoi cells whose centre sits close
    to >= 2 foreground points (the cells are host geometry)."""
    from scipy.spatial import Voronoi

    cleaned = remove_small_regions(mask, min_region_size, DEV.resolve(device))
    ys, xs = np.nonzero(cleaned)
    if len(xs) < 4:
        return cleaned
    points = np.column_stack([xs, ys]).astype(float)
    vor = Voronoi(points)
    out = cleaned.copy()
    h, w = mask.shape
    for region_idx in vor.point_region:
        region = vor.regions[region_idx]
        if not region or -1 in region:
            continue
        polygon = vor.vertices[region]
        center = polygon.mean(axis=0)
        d = np.linalg.norm(points - center, axis=1)
        if (d <= connection_distance * 2).sum() >= 2:
            _fill_polygon(out, polygon, h, w)
    return out


def _fill_polygon(out: np.ndarray, polygon: np.ndarray, h: int, w: int) -> None:
    """Rasterize a convex polygon (Voronoi cells are convex) by scanline."""
    ys = polygon[:, 1]
    y0, y1 = int(max(0, np.floor(ys.min()))), int(min(h - 1, np.ceil(ys.max())))
    n = len(polygon)
    for y in range(y0, y1 + 1):
        xs = []
        for i in range(n):
            x1p, y1p = polygon[i]
            x2p, y2p = polygon[(i + 1) % n]
            if (y1p <= y < y2p) or (y2p <= y < y1p):
                t = (y - y1p) / (y2p - y1p)
                xs.append(x1p + t * (x2p - x1p))
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            a = int(max(0, np.ceil(xs[j])))
            b = int(min(w - 1, np.floor(xs[j + 1])))
            if b >= a:
                out[y, a : b + 1] = True


def connect_nearby_pixels(mask: np.ndarray, connection_distance: int = 3, method: str = "dilation",
                          min_region_size: int = 5, device=None) -> np.ndarray:
    """Strategy dispatcher: voronoi, skeleton, region_growing, closing, or
    (anything else) dilation."""
    if method == "voronoi":
        return connect_by_voronoi(mask, connection_distance, min_region_size, device)
    if method == "skeleton":
        return connect_by_skeleton(mask, connection_distance, device)
    if method == "region_growing":
        return connect_by_region_growing(mask, connection_distance, min_region_size, device)
    if method == "closing":
        return connect_by_closing(mask, connection_distance, device)
    return connect_by_dilation(mask, connection_distance, min_region_size, device)


# ---------------------------------------------------------------------------
# Legacy thin-structure scoring (thin_regions.py v1)
# ---------------------------------------------------------------------------

def _convex_hull_area(points: np.ndarray) -> float:
    """Monotone-chain hull area (cv2.convexHull + contourArea analogue)."""
    pts = np.unique(points, axis=0)
    if len(pts) < 3:
        return 0.0
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    hull = np.asarray(lower[:-1] + upper[:-1], float)
    x, y = hull[:, 0], hull[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def region_thinness_v1(region_mask: np.ndarray) -> float:
    """Legacy thinness blend: perimeter compactness, bbox aspect ratio and
    solidity (host geometry)."""
    area = float(region_mask.sum())
    if area == 0:
        return 0.0
    contours = CONT.find_contours(region_mask)
    if not contours:
        return 0.0
    main = max(contours, key=len)
    perimeter = float(np.linalg.norm(np.diff(main, axis=0), axis=1).sum())
    compactness = (perimeter**2) / (4.0 * np.pi * area) if area else 0.0
    ys, xs = np.nonzero(region_mask)
    hgt = ys.max() - ys.min() + 1
    wid = xs.max() - xs.min() + 1
    aspect = max(hgt, wid) / max(min(hgt, wid), 1)
    hull_area = _convex_hull_area(np.column_stack([ys, xs]))
    solidity = area / hull_area if hull_area > 0 else 1.0
    score = (
        0.4 * min(compactness / 10.0, 1.0)
        + 0.3 * min((aspect - 1.0) / 9.0, 1.0)
        + 0.3 * (1.0 - min(solidity, 1.0))
    )
    return float(np.clip(score, 0.0, 1.0))


def remove_thin_structures_v1(binary: np.ndarray, thinness_threshold: float = 0.5,
                              min_region_size: int = 10, density_threshold: float = 0.2,
                              window_size: int = 25, device=None) -> np.ndarray:
    """Per-region legacy thinness filter: components of low local edge
    density (the box filter on `device`) whose thinness exceeds the
    threshold are dropped."""
    dev = DEV.resolve(device)
    labels, num = CC.connected_components(binary, connectivity=8, device=dev)
    if num <= 1:
        return np.asarray(binary, bool)
    density = CONV.box_density(_dev(np.asarray(binary), dev), window_size).cpu().numpy()
    dens = CC.label_means(labels, density, num)
    areas = CC.component_stats(labels, num).areas
    drop = []
    for lab in range(1, num):
        if areas[lab] < min_region_size:
            continue
        if dens[lab] >= density_threshold:
            continue
        if region_thinness_v1(labels == lab) > thinness_threshold:
            drop.append(lab)
    return CC.remove_labels(np.asarray(binary, bool), labels, np.asarray(drop))


# ---------------------------------------------------------------------------
# Hierarchical contextual cleaning (others.py)
# ---------------------------------------------------------------------------

def build_region_hierarchy(regions: list) -> dict:
    """Parent/child mapping by centroid-in-bbox containment."""
    hierarchy = {i: [] for i in range(len(regions))}
    for i, child in enumerate(regions):
        ys, xs = np.nonzero(child.bbox_mask)
        cy = child.bbox[0] + ys.mean()
        cx = child.bbox[1] + xs.mean()
        for j, parent in enumerate(regions):
            if i == j:
                continue
            minr, minc, maxr, maxc = parent.bbox
            if minr <= cy < maxr and minc <= cx < maxc and parent.area > child.area:
                hierarchy[j].append(i)
                break
    return hierarchy


def contextual_region_cleaning(roi_regions: list, nonroi_regions: list, max_flip_area: int = 500):
    """Flip small regions fully inside regions of the other kind; returns
    (roi, nonroi) lists of `models/segment.py Region`."""
    all_regions = list(roi_regions) + list(nonroi_regions)
    kinds = ["roi"] * len(roi_regions) + ["nonroi"] * len(nonroi_regions)
    hierarchy = build_region_hierarchy(all_regions)
    flipped = list(kinds)
    for parent, children in hierarchy.items():
        for child in children:
            if all_regions[child].area <= max_flip_area and kinds[child] != kinds[parent]:
                flipped[child] = kinds[parent]
    new_roi, new_nonroi = [], []
    for region, kind in zip(all_regions, flipped):
        target = new_roi if kind == "roi" else new_nonroi
        target.append(dataclasses.replace(region, kind=kind))
    return new_roi, new_nonroi


# ---------------------------------------------------------------------------
# Watershed segmentation (the alternative to SLIC)
# ---------------------------------------------------------------------------

def watershed_segments(image_rgb: np.ndarray, mask: np.ndarray, n_segments: int = 100,
                       device=None) -> np.ndarray:
    """Marker-based watershed on the in-mask distance transform.

    Markers are local maxima of the distance transform over a window of
    2 * min_distance + 1, min_distance ~ sqrt(area / n) (a host maximum
    filter); the flood goes level by level down the rounded distances, each
    level one label adoption on `device`.  Returns (h, w) int32 labels, 0
    outside the mask."""
    import scipy.ndimage as ndi

    dev = DEV.resolve(device)
    mask = np.asarray(mask, bool)
    if not mask.any():
        return np.zeros(mask.shape, np.int32)
    dist = DIST.distance_transform_l2(_dev(mask, dev)).cpu().numpy()
    min_distance = max(5, int(np.sqrt(mask.sum() / max(n_segments, 1))))
    win_max = ndi.maximum_filter(dist, size=2 * min_distance + 1)
    peaks = (dist == win_max) & (dist > 0) & mask
    labels = np.zeros(mask.shape, np.int32)
    pys, pxs = np.nonzero(peaks)
    labels[pys, pxs] = np.arange(1, len(pys) + 1, dtype=np.int32)

    levels = np.unique(np.round(dist[mask], 0))[::-1]
    dist_d = _dev(dist, dev)
    mask_d = _dev(mask, dev)
    current = _dev(labels, dev)
    for level in levels:
        allowed = mask_d & (dist_d >= float(level))
        current = CC.adopt_labels(current, current > 0, allowed).to(torch.int32)
        current = torch.where(allowed, current, torch.zeros((), dtype=torch.int32, device=dev))
    current = torch.where(mask_d, current, torch.zeros((), dtype=torch.int32, device=dev))
    return current.cpu().numpy()
