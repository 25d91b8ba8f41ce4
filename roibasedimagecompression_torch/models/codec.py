"""Top-level codec: encode() / decode().

Pipeline of the batched path (the JAX package's `encode_batched`):
  native threshold selection + ROI masks -> region extraction -> split score
  and SLIC per region on the device -> tier-1 pair table, eps-CC and
  oversized splits -> tiers 2/3 composed on the cluster table, palette
  refinement and refit -> DEFLATE container.

The canvas tiers path (`fill_black_holes > 0`, an image without segments, or
RHCCQ_CANVAS_TIERS=1) paints tier 1 onto a canvas and clusters tiers 2 and 3
as colour maps (`tiers23_colors_many`), so the holes of the tier-2 canvas can
be filled before tier 3; without holes to fill it writes the same bytes as
the composed path.

`CodecConfig(batched=False)` takes the reference-shaped loop instead: ROI
masks (`models/roi.py`) -> regions -> per-region split score and SLIC, and
per-segment palette clustering (`subregion_quantization`) -> tier 2 per
region group -> tier 3 on the whole image (`models/quantize.py`) ->
container.  `single_region=True` treats the whole image as one ROI region.
"""

from __future__ import annotations

import os

import numpy as np

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.io import container as C
from roibasedimagecompression_torch.models import holes as HOLES
from roibasedimagecompression_torch.models import quantize as Q
from roibasedimagecompression_torch.models import quantize_batched as QB
from roibasedimagecompression_torch.models import refine as RF
from roibasedimagecompression_torch.models import segment as SEG
from roibasedimagecompression_torch.ops import unique as U
from roibasedimagecompression_torch.utils import device as DEV
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.timing import stage_timer


def _black_repair(pixels: np.ndarray) -> np.ndarray:
    """Every black pixel of a segment takes the segment's darkest non-black
    colour (the nearest to black by L2 in colour space)."""
    black = np.all(pixels == 0, axis=1)
    if not black.any():
        return pixels
    non_black = pixels[~black]
    if len(non_black) == 0:
        return pixels
    norms = (non_black.astype(np.int64) ** 2).sum(axis=1)
    darkest = non_black[np.argmin(norms)]
    out = pixels.copy()
    out[black] = darkest
    return out


def subregion_quantization(image_rgb: np.ndarray, regions: list, quality: float,
                           config: cfg.CodecConfig, device) -> list:
    """Tier 1 of the loop: per region, the split score sets the SLIC segment
    count; each segment's pixels (black repaired, within a `segment_pad`
    margin of its bbox) are clustered as one palette.  Returns one merged
    Component per region."""
    out = []
    for region in regions:
        minr, minc, maxr, maxc = region.bbox
        crop = image_rgb[minr:maxr, minc:maxc]
        mask = region.bbox_mask

        n_seg = SEG.optimal_segments(crop, mask, device)
        labels = SEG.region_segments(
            crop, mask, n_seg, device,
            compactness=config.slic_compactness, sigma=config.slic_sigma,
        )

        comps = []
        for seg_id in range(1, int(labels.max()) + 1):
            seg_mask = labels == seg_id
            if not seg_mask.any():
                continue
            rows = np.flatnonzero(seg_mask.any(axis=1))
            cols = np.flatnonzero(seg_mask.any(axis=0))
            pad = config.segment_pad
            r0 = max(0, rows[0] - pad)
            r1 = min(crop.shape[0] - 1, rows[-1] + pad)
            c0 = max(0, cols[0] - pad)
            c1 = min(crop.shape[1] - 1, cols[-1] + pad)

            seg_crop_mask = seg_mask[r0 : r1 + 1, c0 : c1 + 1]
            bbox_crop = crop[r0 : r1 + 1, c0 : c1 + 1]
            seg_img = np.zeros_like(bbox_crop)
            seg_img[seg_crop_mask] = _black_repair(bbox_crop[seg_crop_mask])

            comp = Q.from_pixels(seg_img, (minr + r0, minc + c0), device)
            comps.append(Q.cluster_component(comp, quality, device, seed=config.seed))

        if not comps:
            continue
        out.append(Q.merge_components(comps, region.bbox) if len(comps) > 1 else comps[0])
    return out


def _extract_and_assign(image_rgb, roi_mask, nonroi_mask, config, min_size, device=None):
    """Region extraction + small-ROI demotion, or with config.region_fusion
    the two-way reassignment and fusion of touching regions."""
    if config.region_fusion:
        return SEG.process_regions_with_reassignment(image_rgb, roi_mask, nonroi_mask, device)
    roi_regions = SEG.extract_regions(roi_mask, "roi", device)
    nonroi_regions = SEG.extract_regions(nonroi_mask, "nonroi", device)
    return SEG.reassign_small_roi(roi_regions, nonroi_regions, min_size)


def build_segment_maps_many(images: list, regions_per_image: list,
                            config: cfg.CodecConfig, device,
                            return_dbatch: bool = False, mesh=None):
    """Rasterize per-region SLIC segments into global (h, w) id maps for a
    batch of images.

    Returns (seg_map, seg_quality (n+1,), seg_group (n+1,)) per image, with
    1=roi, 2=nonroi group ids.  ROI regions rasterize last, so they win the
    buffer-zone overlaps.  All regions of all images pool into the same
    split-score and SLIC buckets; same-shape images go to the device once,
    with one region-id raster per kind, and crops are sliced there.

    With return_dbatch the result is (list, DeviceBatch or None): the batch
    on the device, whose pixels the tier-1 device pair table reads again.
    With `mesh`, the split-score and SLIC buckets split their rows over its
    data devices.
    """
    flat_regions = []  # (image_idx, region), nonroi first then roi per image
    for k, (roi_regions, nonroi_regions) in enumerate(regions_per_image):
        for region in list(nonroi_regions) + list(roi_regions):
            flat_regions.append((k, region))

    crops, masks = [], []
    for k, region in flat_regions:
        minr, minc, maxr, maxc = region.bbox
        crops.append(images[k][minr:maxr, minc:maxc])
        masks.append(region.bbox_mask)

    dbatch = None
    sources = None
    if len({im.shape for im in images}) == 1 and 0 < len(flat_regions) < 65535:
        h, w = images[0].shape[:2]
        reg_a = np.zeros((len(images), h, w), np.int32)  # nonroi regions
        reg_b = np.zeros((len(images), h, w), np.int32)  # roi regions
        sources = []
        for j, (k, region) in enumerate(flat_regions):
            minr, minc, maxr, maxc = region.bbox
            kind = 1 if region.kind == "roi" else 0
            target = reg_b if kind else reg_a
            target[k, minr:maxr, minc:maxc][region.bbox_mask] = j + 1
            sources.append((k, minr, minc, maxr - minr, maxc - minc, j + 1, kind))
        with stage_timer("seg.upload"):
            dbatch = SEG.DeviceBatch(
                np.stack([np.asarray(im, np.uint8) for im in images]), reg_a, reg_b, device
            )

    n_segs = SEG.optimal_segments_many(crops, masks, device, sources=sources, dbatch=dbatch,
                                       mesh=mesh)
    labels_list = SEG.region_segments_many(
        crops, masks, n_segs, device,
        compactness=config.slic_compactness, sigma=config.slic_sigma,
        sources=sources, dbatch=dbatch, mesh=mesh,
    )

    results = []
    pos = 0
    for k, (roi_regions, nonroi_regions) in enumerate(regions_per_image):
        h, w = images[k].shape[:2]
        seg_map = np.zeros((h, w), np.int32)
        qualities = [0.0]
        groups = [0]
        next_id = 1
        for region in list(nonroi_regions) + list(roi_regions):
            labels = labels_list[pos]
            pos += 1
            n_local = int(labels.max())
            if n_local == 0:
                continue
            minr, minc, maxr, maxc = region.bbox
            view = seg_map[minr:maxr, minc:maxc]
            sel = labels > 0
            view[sel] = labels[sel] + (next_id - 1)
            q = config.roi_quality if region.kind == "roi" else config.nonroi_quality
            g = 1 if region.kind == "roi" else 2
            qualities.extend([q] * n_local)
            groups.extend([g] * n_local)
            next_id += n_local
        results.append(
            (seg_map, np.asarray(qualities, np.float64), np.asarray(groups, np.int32))
        )
    if return_dbatch:
        return results, dbatch
    return results


def build_segment_map(image_rgb, roi_regions, nonroi_regions, config, device):
    """Single-image segment map (see build_segment_maps_many)."""
    return build_segment_maps_many(
        [image_rgb], [(roi_regions, nonroi_regions)], config, device
    )[0]


def _pow2_refit(n: int, minimum: int = 64) -> int:
    """Power-of-two bucket for the refit table's per-image stride."""
    p = minimum
    while p < n:
        p *= 2
    return p


def _apply_refit_sums(palette: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Finish the device refit: rows = (len(palette), 4) int32
    [count, sum_r, sum_g, sum_b]; the frozen-black law and the float64
    round(sums / count) of refine.refit_pixels, so the result equals the host
    bincount path."""
    pal = np.asarray(palette, np.uint8)
    if len(pal) == 0:
        return pal.copy()
    frozen = (pal == 0).all(axis=1)
    if bool(frozen.all()):
        return pal.copy()
    cnt = rows[:, 0].astype(np.int64)
    sums = rows[:, 1:4].astype(np.float64)
    upd = (~frozen) & (cnt > 0)
    out = pal.copy()
    out[upd] = np.round(sums[upd] / cnt[upd, None]).astype(np.uint8)
    return out


def tiers23_palette_indices(
    table: dict,
    seg_group: np.ndarray,
    image_of_seg: np.ndarray,
    n_images: int,
    shape: tuple,
    config: cfg.CodecConfig,
    device,
    refit_originals: np.ndarray | None = None,
    mesh=None,
) -> list:
    """Tiers 2/3 + final palette, composed on the tier-1 CLUSTER table.

    Each tier-1 cluster paints one uint8 color, so the tier-2 problem's
    palette is the unique (problem, color) set over cluster colors, tier-3's
    the unique (image, tier-2 color) set, and the final palette the unique
    tier-3 colors: tables of cluster-count length.  Pixels are touched once,
    in the final palette-index paint.

    refit_originals: optional (b, h, w, 3) uint8 original images.  When given
    and the config enables the zero-rate palette refit, the returned palettes
    are already refitted (refine.refit_pixels semantics, bit-identical): the
    device pair table accumulates the count and RGB-sum table where the
    pixels are, the host-paint branch calls refit_pixels.  A caller that
    passes it skips its own maybe_refit.

    Returns a list of (palette (m, 3) uint8, indices (h, w) minimal unsigned
    dtype) per image of the stacked table.
    """
    h, w = shape
    b = n_images
    cop = table["cluster_of_pair"]
    cluster_colors = table["cluster_colors"]
    n_clusters = len(cluster_colors)

    with stage_timer("t23.compose"):
        seg_of_cluster = np.zeros(n_clusters, np.int64)
        seg_of_cluster[cop] = table["seg_of_pair"]
        w_cluster = np.bincount(cop, weights=table["pair_weights"], minlength=n_clusters)
        img_of_cluster = image_of_seg[seg_of_cluster].astype(np.int64)
        grp_of_cluster = seg_group[seg_of_cluster].astype(np.int64)
        packed1 = (
            (cluster_colors[:, 0].astype(np.int64) << 16)
            | (cluster_colors[:, 1].astype(np.int64) << 8)
            | cluster_colors[:, 2].astype(np.int64)
        )
        # ---- tier 2: one problem per (image, group) ----
        prob2 = img_of_cluster * 2 + (grp_of_cluster - 1)
        uniq2, inv2 = QB._unique_inverse(prob2 << 24 | packed1)
        w2 = np.bincount(inv2, weights=w_cluster)
        qual2 = [
            config.roi_tier2_quality if p % 2 == 0 else config.nonroi_tier2_quality
            for p in range(2 * b)
        ]
    out2 = QB.cluster_pair_table(
        uniq2, w2, qual2, device, seed=config.seed,
        split_method=config.split_method, split_margin=config.split_margin,
        weighted_split=config.weighted_split, weighted=config.weighted_palette, mesh=mesh,
    )
    with stage_timer("t23.compose"):
        c2_packed = (
            (out2[:, 0].astype(np.int64) << 16)
            | (out2[:, 1].astype(np.int64) << 8)
            | out2[:, 2].astype(np.int64)
        )[inv2]
        # ---- tier 3: one problem per image ----
        uniq3, inv3 = QB._unique_inverse(img_of_cluster << 24 | c2_packed)
        w3 = np.bincount(inv3, weights=w_cluster)
    out3 = QB.cluster_pair_table(
        uniq3, w3, [config.image_quality] * b, device, seed=config.seed,
        split_method=config.split_method, split_margin=config.split_margin,
        weighted_split=config.weighted_split, weighted=config.weighted_palette, mesh=mesh,
    )
    with stage_timer("t23.compose"):
        c3_packed = (
            (out3[:, 0].astype(np.int64) << 16)
            | (out3[:, 1].astype(np.int64) << 8)
            | out3[:, 2].astype(np.int64)
        )[inv3]
        # ---- final palette per image (unique_colors semantics) ----
        uniq4, inv4 = QB._unique_inverse(img_of_cluster << 24 | c3_packed)
        img4 = (uniq4 >> 24).astype(np.int64)
        col4 = uniq4 & 0xFFFFFF
        starts4 = np.searchsorted(img4, np.arange(b + 1))
        # Background black joins the palette exactly when the image has
        # background pixels (or a tier-3 color is already black).
        mask = table["mask"]
        bg_counts = (h * w) - mask.reshape(b, h * w).sum(axis=1)
        sizes4 = np.diff(starts4)
        first_is_black = np.zeros(b, bool)
        nonempty = sizes4 > 0
        first_is_black[nonempty] = col4[starts4[:-1][nonempty]] == 0
        add_black = (bg_counts > 0) & ~first_is_black
        idx_of_cluster = (
            inv4 - starts4[:-1][img_of_cluster] + add_black[img_of_cluster]
        ).astype(np.int64)
        results = []
        for i in range(b):
            pal_packed = col4[starts4[i] : starts4[i + 1]]
            if add_black[i]:
                pal_packed = np.concatenate([[0], pal_packed])
            results.append(
                np.stack(
                    [(pal_packed >> 16) & 0xFF, (pal_packed >> 8) & 0xFF, pal_packed & 0xFF],
                    axis=1,
                ).astype(np.uint8)
            )

        # ---- global palette refinement on the (cluster color, mass) table ----
        refine_iters = RF.effective_iters(config)
        if refine_iters > 0:
            with stage_timer("t23.refine"):
                for i in range(b):
                    sel = img_of_cluster == i
                    if not sel.any():
                        continue
                    new_pal, assign = RF.refine_palette(
                        cluster_colors[sel], w_cluster[sel], results[i], refine_iters,
                    )
                    results[i] = new_pal
                    idx_of_cluster[sel] = assign

        # ---- the one pixel pass: paint palette indices ----
        idx_of_pair = idx_of_cluster[cop].astype(np.int32)
        inverse = table["inverse"]
        do_refit = refit_originals is not None and RF.effective_refit(config)
        out = []
        if inverse is None:
            # Device pair table: the pixel -> pair mapping lives on the
            # device; one gather and scatter paints the final indices.
            refit_bins = None
            # int32 sums stay exact only while 255 * hw < 2^31; larger images
            # take the host refit.
            if do_refit and 255 * h * w < 2**31:
                k_pad = _pow2_refit(max(len(p) for p in results))
                refit_bins = (b, h * w, k_pad)
            painted = table["device_pairs"].paint(
                idx_of_pair, table["repair_remap"], refit_bins=refit_bins
            )
            if refit_bins is not None:
                flat, sums = painted
                for i in range(b):
                    results[i] = _apply_refit_sums(
                        results[i], sums[i * k_pad : i * k_pad + len(results[i])]
                    )
            else:
                flat = painted
            for i in range(b):
                pal = results[i]
                idx_map = flat[i * h * w : (i + 1) * h * w].reshape(h, w)
                if refit_bins is None and do_refit:
                    pal = RF.refit_pixels(refit_originals[i], pal, idx_map)
                dt = C.min_index_dtype(max(len(pal) - 1, 0))
                out.append((pal, idx_map.astype(dt, copy=False)))
            return out
        n_masked = (h * w) - bg_counts
        offs = np.concatenate([[0], np.cumsum(n_masked)])
        for i in range(b):
            pal = results[i]
            idx_map = np.zeros((h, w), C.min_index_dtype(max(len(pal) - 1, 0)))
            inv_i, mask_i = inverse[offs[i] : offs[i + 1]], mask[i * h : (i + 1) * h]
            if not native.paint_masked_indices(idx_of_pair, inv_i, mask_i, idx_map):
                idx_map.reshape(-1)[np.flatnonzero(mask_i.ravel())] = idx_of_pair[inv_i].astype(
                    idx_map.dtype)
            if do_refit:
                pal = RF.refit_pixels(refit_originals[i], pal, idx_map)
            out.append((pal, idx_map))
    return out


def tiers23_colors_many(t1_list: list, group_map_list: list, config: cfg.CodecConfig,
                        device, mesh=None) -> tuple:
    """Tier-2 and tier-3 colour maps of a batch of tier-1 canvases, in two
    pooled `cluster_color_maps_many` calls: tier 2 one problem per (image,
    group), then the optional black-hole fill, then tier 3 one problem per
    image.  Returns (t2_list, t3_list) of (h, w, 3) uint8 colour maps."""
    kw = dict(seed=config.seed, weighted=config.weighted_palette,
              split_method=config.split_method, split_margin=config.split_margin,
              weighted_split=config.weighted_split, mesh=mesh)
    colors_in, sels, quals, owner = [], [], [], []
    for k, (t1, gm) in enumerate(zip(t1_list, group_map_list)):
        for g, q2 in ((1, config.roi_tier2_quality), (2, config.nonroi_tier2_quality)):
            sel = gm == g
            if sel.any():
                colors_in.append(t1)
                sels.append(sel)
                quals.append(q2)
                owner.append(k)
    t2_list = [np.zeros_like(t1) for t1 in t1_list]
    if colors_in:
        QB.cluster_color_maps_many(colors_in, sels, quals, [t2_list[k] for k in owner], device, **kw)

    if config.fill_black_holes > 0:
        t2_list = [HOLES.fill_black_holes(t2, config.fill_black_holes, device) for t2 in t2_list]

    colors_in, sels, owner = [], [], []
    for k, (t2, gm) in enumerate(zip(t2_list, group_map_list)):
        sel = gm > 0
        if config.fill_black_holes > 0:
            # Filled pixels join tier 3 even outside every region.
            sel = sel | (t2 != 0).any(axis=-1)
        if sel.any():
            colors_in.append(t2)
            sels.append(sel)
            owner.append(k)
    t3_list = [np.zeros_like(t2) for t2 in t2_list]
    if colors_in:
        QB.cluster_color_maps_many(
            colors_in, sels, [config.image_quality] * len(colors_in), [t3_list[k] for k in owner],
            device, **kw,
        )
    return t2_list, t3_list


def canvas_palette_indices(t3: np.ndarray, t1: np.ndarray, config: cfg.CodecConfig,
                           device=None):
    """Final palette and index map of a tier-3 canvas (its unique colours),
    refined on the tier-1 canvas where the config refines."""
    h, w = t3.shape[:2]
    palette, indices = U.unique_colors(t3.reshape(-1, 3), device)
    indices = indices.reshape(h, w)
    iters = RF.effective_iters(config)
    if iters > 0:
        palette, indices = RF.refine_canvas(t1, palette, iters)
    return palette, indices


def canvas_tiers(config: cfg.CodecConfig) -> bool:
    """Whether tiers 2/3 run on canvases: fill_black_holes edits the tier-2
    canvas; RHCCQ_CANVAS_TIERS=1 asks for the path outright."""
    return config.fill_black_holes > 0 or os.environ.get("RHCCQ_CANVAS_TIERS") == "1"


def _coerce_rgb(image: np.ndarray) -> np.ndarray:
    """Accept (h, w), (h, w, 1), (h, w, 3) or (h, w, 4) uint8 input."""
    image = np.asarray(image, dtype=np.uint8)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    elif image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    elif image.shape[-1] == 4:
        image = image[..., :3]
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected an RGB image, got shape {image.shape}")
    return np.ascontiguousarray(image)


def _single_region(h: int, w: int) -> list:
    """The whole image as one ROI region."""
    return [SEG.Region(bbox=(0, 0, h, w), bbox_mask=np.ones((h, w), bool), area=h * w, kind="roi")]


def encode_batched(image_rgb: np.ndarray, config: cfg.CodecConfig, device) -> bytes:
    """Batched encode path: device-bucketed tier 1, table-composed tiers 2/3."""
    from roibasedimagecompression_torch.models import roi_fused as ROI
    from roibasedimagecompression_torch.ops import canny as CANNY

    image_rgb = _coerce_rgb(image_rgb)
    h, w = image_rgb.shape[:2]
    min_size = cfg.min_region_size(image_rgb.size)

    with stage_timer("roi"):
        if config.single_region:
            roi_regions, nonroi_regions = _single_region(h, w), []
        else:
            if config.fast_edges:
                # The same reduced-candidate law as the batch frontend.
                lows, highs = CANNY.fast_thresholds_many(image_rgb[None], device)
                low, high = float(lows[0]), float(highs[0])
            else:
                low, high = CANNY.select_thresholds_pair(image_rgb, device)
            roi_mask, nonroi_mask = ROI.roi_masks_fast(image_rgb, config, low, high, device)
            roi_regions, nonroi_regions = _extract_and_assign(
                image_rgb, roi_mask, nonroi_mask, config, min_size, device
            )

    with stage_timer("segment"):
        seg_map, seg_quality, seg_group = build_segment_map(
            image_rgb, roi_regions, nonroi_regions, config, device
        )

    with stage_timer("tier1"):
        table = QB.tier1_table(
            image_rgb, seg_map, seg_quality, device, seed=config.seed,
            weighted=config.weighted_palette, split_method=config.split_method,
            split_margin=config.split_margin, weighted_split=config.weighted_split,
        )

    with stage_timer("tier23"):
        if table is None or canvas_tiers(config):
            # Canvas path: hole filling edits the tier-2 canvas; an empty
            # table means an image without segments.
            t1 = np.zeros_like(image_rgb)
            if table is not None:
                QB.paint_table(table, t1)
            _, (t3,) = tiers23_colors_many([t1], [seg_group[seg_map]], config, device)
            palette, indices = canvas_palette_indices(t3, t1, config, device)
        else:
            image_of_seg = np.zeros(len(seg_quality), np.int32)
            ((palette, indices),) = tiers23_palette_indices(
                table, seg_group, image_of_seg, 1, (h, w), config, device
            )
        palette = RF.maybe_refit(image_rgb, palette, indices, config)

    with stage_timer("container"):
        return C.pack(palette, indices, level=config.container_level)


def encode_debug(image_rgb: np.ndarray, config: cfg.CodecConfig | None = None,
                 device=None) -> dict:
    """Encode while exposing every intermediate: a dict of 'roi_mask',
    'nonroi_mask', 'seg_map', 'tier1', 'tier2', 'tier3' (RGB canvases) and
    'data' (the .rhccq bytes).  The masks come from `roi_fused.roi_masks`,
    whose graph with `fast_edges` off is the device one, runtime or not; the
    tiers are the canvas path's.  device=None runs on CUDA; pass "cpu" for
    the CPU."""
    from roibasedimagecompression_torch.models import roi_fused as ROI

    config = config or cfg.CodecConfig()
    device = DEV.resolve(device)
    image_rgb = np.ascontiguousarray(np.asarray(image_rgb, dtype=np.uint8))
    h, w = image_rgb.shape[:2]
    min_size = cfg.min_region_size(image_rgb.size)

    if config.single_region:
        roi_mask = np.ones((h, w), bool)
        nonroi_mask = np.zeros((h, w), bool)
        roi_regions, nonroi_regions = _single_region(h, w), []
    else:
        roi_mask, nonroi_mask = ROI.roi_masks(image_rgb, config, device)
        roi_regions, nonroi_regions = _extract_and_assign(
            image_rgb, roi_mask, nonroi_mask, config, min_size, device
        )

    seg_map, seg_quality, seg_group = build_segment_map(
        image_rgb, roi_regions, nonroi_regions, config, device
    )
    t1 = QB.tier1_colors(
        image_rgb, seg_map, seg_quality, device, seed=config.seed,
        weighted=config.weighted_palette, split_method=config.split_method,
        split_margin=config.split_margin, weighted_split=config.weighted_split,
    )
    group_map = np.where(seg_map > 0, seg_group[seg_map], 0)
    (t2,), (t3,) = tiers23_colors_many([t1], [group_map], config, device)
    palette, indices = canvas_palette_indices(t3, t1, config, device)
    palette = RF.maybe_refit(image_rgb, palette, indices, config)
    return {
        "roi_mask": roi_mask,
        "nonroi_mask": nonroi_mask,
        "seg_map": seg_map,
        "tier1": t1,
        "tier2": t2,
        "tier3": t3,
        "data": C.pack(palette, indices, level=config.container_level),
    }


def encode(image_rgb: np.ndarray, config: cfg.CodecConfig | None = None,
           device=None) -> bytes:
    """Encode an (h, w, 3) uint8 RGB image to .rhccq bytes.

    device=None runs on CUDA (and raises without a card); pass "cpu" for the
    CPU.
    """
    config = config or cfg.CodecConfig()
    device = DEV.resolve(device)
    with timing.request("encode"):
        if config.batched:
            return encode_batched(image_rgb, config, device)
        return encode_loop(image_rgb, config, device)


def encode_loop(image_rgb: np.ndarray, config: cfg.CodecConfig, device) -> bytes:
    """The reference-shaped loop (`CodecConfig(batched=False)`): ROI masks,
    then regions one by one through SLIC and tier 1, one palette problem at a
    time through tiers 2 and 3."""
    image_rgb = np.ascontiguousarray(np.asarray(image_rgb, dtype=np.uint8))
    h, w = image_rgb.shape[:2]
    min_size = cfg.min_region_size(image_rgb.size)

    with stage_timer("roi"):
        if config.single_region:
            roi_regions, nonroi_regions = _single_region(h, w), []
        else:
            from roibasedimagecompression_torch.models import roi as ROI

            roi_mask, nonroi_mask = ROI.roi_masks(image_rgb, config, device)
            roi_regions, nonroi_regions = _extract_and_assign(
                image_rgb, roi_mask, nonroi_mask, config, min_size, device
            )

    with stage_timer("tier1"):
        roi_comps = subregion_quantization(image_rgb, roi_regions, config.roi_quality, config, device)
        nonroi_comps = subregion_quantization(
            image_rgb, nonroi_regions, config.nonroi_quality, config, device
        )

    with stage_timer("tier2"):
        image_components = []
        for comps, q2 in ((roi_comps, config.roi_tier2_quality),
                          (nonroi_comps, config.nonroi_tier2_quality)):
            if comps:
                image_components.append(Q.region_quantization(comps, h, w, q2, device, seed=config.seed))

    with stage_timer("tier3"):
        final = Q.quantize_image(image_components, h, w, config.image_quality, device,
                                 seed=config.seed)

    with stage_timer("container"):
        palette, indices = final.palette, final.indices
        iters = RF.effective_iters(config)
        if iters > 0:
            # The tier-1 canvas: every tier-1 component merged, the first
            # wins and black never writes, as the batched path's paint.
            t1 = Q.merge_components(roi_comps + nonroi_comps, (0, 0, h, w)).to_rgb()
            palette, indices = RF.refine_canvas(t1, palette, iters)
        palette = RF.maybe_refit(image_rgb, palette, indices, config)
        return C.pack(palette, indices, level=config.container_level)


def decode(source) -> np.ndarray:
    """Decode .rhccq bytes or a file path to (h, w, 3) uint8 RGB."""
    if isinstance(source, (bytes, bytearray)):
        return C.unpack(bytes(source)).to_rgb()
    return C.decode_file(source)
