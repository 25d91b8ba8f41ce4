"""Batched tier-1 quantization: every segment's palette clustered at once.

Segments are disjoint and black pixels never write during canvas merges, so
tier 1 + the per-region and tier-2 merges collapse to a per-pixel map, and
the eps-graph clustering of MANY segment palettes runs as one padded batch
per bucket cap (block-diagonal by construction: one run per row).  Oversized
clusters split level-synchronously: small ones by host PCA median cuts, large
ones by batched device k-means.

The pair tables, keys and bookkeeping are host numpy and the native runtime,
as in the JAX package (without the runtime, RHCCQ_NATIVE=0, the JAX
package's numpy branches, which give the same tables); the eps-CC sweeps run
through the CUDA kernel on the card, and on the CPU through the native
union-find, or the plain sweep without the runtime or under
RHCCQ_EPSCC=device (all give the same run-local minimum-member labels, so the
keys are identical), and k-means runs as torch ops on the caller's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.ops import cluster as CL
from roibasedimagecompression_torch.ops.cuda import epscc as EPS
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import dispatch as DISPATCH
from roibasedimagecompression_torch.utils.timing import stage_timer

_BUCKETS = (64, 256, 1024, 4096, 9999)  # eps-CC caps (>=10k goes to k-means)
_SPLIT_CAPS = (64, 256, 1024, 4096, 16384, 65536)
_HYBRID_CUTOFF = 64  # RHCCQ_HYBRID_CUTOFF overrides it


def _weighted_split_on(flag: bool) -> bool:
    """RHCCQ_WEIGHTED_SPLIT overrides the config flag, parsed as the JAX
    package parses it (unset: the flag; "" or "0": off; anything else: on)."""
    env = os.environ.get("RHCCQ_WEIGHTED_SPLIT")
    if env is None:
        return flag
    return env not in ("", "0")


_WEIGHT_DROP_WARNED: set = set()


def _warn_weights_dropped(reason: str) -> None:
    """One warning per reason and process where the weighted split runs
    unweighted: the median cuts, the PCA-chunk init and the >65536-colour
    host k-means have no weighted form."""
    if reason in _WEIGHT_DROP_WARNED:
        return
    _WEIGHT_DROP_WARNED.add(reason)
    import warnings

    warnings.warn(
        f"weighted_split: {reason} has no weighted kernel; those splits run "
        "unweighted (pixel-mass weighting applies to the device Lloyd path "
        "only)",
        RuntimeWarning,
        stacklevel=3,
    )


def _unique_inverse(keys: np.ndarray, return_counts: bool = False):
    return native.unique_inverse_i64(keys, return_counts)


def _runs_of_sorted(sorted_arr: np.ndarray):
    """(values, starts, counts) of equal runs in an already-sorted array."""
    _, starts, sizes = native.runs_of_sorted_i64(sorted_arr)
    return sorted_arr[starts], starts, sizes


def _pairs_numpy(image_rgb: np.ndarray, seg_map: np.ndarray):
    """(seg_of_pair, color_of_pair, inverse) of the (segment, colour) pairs
    of the seg > 0 pixels, by np.unique (the table `native.pack_pairs`
    builds)."""
    packed = (
        (image_rgb[..., 0].astype(np.int64) << 16)
        | (image_rgb[..., 1].astype(np.int64) << 8)
        | image_rgb[..., 2].astype(np.int64)
    )
    key = seg_map.astype(np.int64) << 24 | packed
    uniq, inverse = _unique_inverse(key[seg_map > 0])
    return (uniq >> 24).astype(np.int32), (uniq & 0xFFFFFF).astype(np.int32), inverse.astype(np.int64)


def _black_repair_numpy(seg_of_pair, color_of_pair, inverse):
    """Per-segment black repair of the pair table in numpy (what
    `native.black_repair_pairs` does): black pairs of a segment with
    non-black colours remap to its darkest non-black pair (least squared
    norm, then least row).  Returns (seg_of_pair, color_of_pair, inverse)
    with those black pairs dropped."""
    rgb = _unpack(color_of_pair).astype(np.int64)
    norm2 = (rgb**2).sum(axis=1)
    is_black = color_of_pair == 0
    n_seg = int(seg_of_pair.max()) + 1 if len(seg_of_pair) else 1
    sentinel = np.iinfo(np.int64).max
    order_key = np.where(is_black, sentinel, norm2 << 44 | np.arange(len(seg_of_pair)))
    darkest = np.full(n_seg, sentinel, np.int64)
    np.minimum.at(darkest, seg_of_pair, order_key)
    has_nonblack = darkest < sentinel
    darkest_idx = np.where(has_nonblack, darkest & ((1 << 44) - 1), -1)
    target = np.arange(len(seg_of_pair), dtype=np.int64)
    repairable = is_black & has_nonblack[seg_of_pair]
    target[repairable] = darkest_idx[seg_of_pair[repairable]]
    keep = ~repairable
    remap = (np.cumsum(keep) - 1)[target]
    return seg_of_pair[keep], color_of_pair[keep], remap[inverse]


def _cluster_means_u8(cluster_of_pair, color_of_pair, weights, n_clusters: int) -> np.ndarray:
    """Weighted per-cluster mean colours truncated to uint8: the runtime's
    pass, or numpy's bincount chain, which it equals bit for bit."""
    out = native.cluster_means_u8(cluster_of_pair, color_of_pair, weights, n_clusters)
    if out is not None:
        return out
    colors = _unpack(color_of_pair).astype(np.float32)
    wv = weights if weights is not None else np.ones(len(cluster_of_pair), np.float64)
    counts = np.bincount(cluster_of_pair, weights=wv, minlength=n_clusters)
    means = np.zeros((n_clusters, 3), np.float64)
    for c in range(3):
        means[:, c] = np.bincount(cluster_of_pair, weights=colors[:, c] * wv, minlength=n_clusters)
    means /= np.maximum(counts, 1.0)[:, None]
    return means.astype(np.uint8)


def _unpack(colors_packed: np.ndarray) -> np.ndarray:
    return np.stack(
        [
            (colors_packed >> 16) & 0xFF,
            (colors_packed >> 8) & 0xFF,
            colors_packed & 0xFF,
        ],
        axis=1,
    ).astype(np.uint8)


def _bucketize(sizes: np.ndarray, caps) -> dict:
    """Group problem ids by the smallest cap that fits them."""
    out: dict = {}
    lo = 0
    for cap in caps:
        sel = np.flatnonzero((sizes <= cap) & (sizes > lo))
        if len(sel):
            out[cap] = sel
        lo = cap
    return out


def _pad_kmax(k: int) -> int:
    """Quantize k_max to powers of two (>= 2)."""
    p = 2
    while p < k:
        p *= 2
    return p


def _assign_trivial_runs(cluster_keys, colors, starts, sizes_inout, eps,
                         key_base) -> np.int64:
    """One-component eps-CC shortcut: a run whose palette bbox diagonal is
    <= eps is one component (the diagonal bounds every pairwise distance),
    so it takes one key without a sweep.  The comparison is float32, like
    the sweep's predicate.  Mutates `cluster_keys` and zeroes `sizes_inout`
    for the runs it labels; returns the number of keys consumed."""
    valid = np.flatnonzero(sizes_inout > 0)
    if len(valid) == 0:
        return np.int64(0)
    n = len(colors)
    st = starts[valid].astype(np.int64)
    en = st + sizes_inout[valid]
    # Segmented min/max over explicit [start, end) bounds (runs need not
    # partition `colors`: tiers 2/3 skip pinned black pairs).
    bounds = np.unique(np.concatenate([st, en[en < n]]))
    seg_of_run = np.searchsorted(bounds, st)
    cmin = np.minimum.reduceat(colors, bounds, axis=0)[seg_of_run]
    cmax = np.maximum.reduceat(colors, bounds, axis=0)[seg_of_run]
    diag2 = ((cmax - cmin).astype(np.float32) ** 2).sum(axis=1)
    diag2[sizes_inout[valid] == 1] = 0.0
    eps2 = eps[valid].astype(np.float32) ** 2
    triv = valid[diag2 <= eps2]
    if len(triv) == 0:
        return np.int64(0)
    flat_pos, flat_row, _ = native.flat_run_positions(starts[triv], sizes_inout[triv])
    cluster_keys[flat_pos] = key_base + flat_row
    sizes_inout[triv] = 0
    return np.int64(len(triv))


def _epscc_native_on() -> bool:
    """The eps-CC backend on the CPU, picked as the JAX package picks it:
    RHCCQ_EPSCC=device forces the sweeps, =native the runtime's union-find,
    otherwise the runtime when it is in use.  The labels are the same."""
    env = os.environ.get("RHCCQ_EPSCC")
    if env == "device":
        return False
    if env == "native":
        return True
    return native.available()


def _epscc_labels_device(color_of_pair, starts, sizes, eps, cap, device, mesh=None) -> np.ndarray:
    """Run-major int32 labels of the runs through the eps-components kernel.

    One upload per bucket: the (b, cap) packed colours (-1 where a run has no
    point, from which the card derives validity) and the b float32 eps^2
    values travel in one int32 buffer.  With `mesh` the rows, padded to a
    multiple of its data axis, split over its data devices."""
    b = len(starts)
    flat_pos, flat_row, within = native.flat_run_positions(starts, sizes)
    bp = SHARD.pad_rows(b, mesh)
    buf = np.full(bp * cap + bp, -1, np.int32)
    buf[flat_row * cap + within] = color_of_pair[flat_pos]
    buf[bp * cap :] = (np.asarray(SHARD.pad_to(np.asarray(eps), bp), np.float32) ** 2).view(np.int32)
    dev_buf = torch.from_numpy(buf).to(device)
    labels, _ = DISPATCH.call(
        EPS.eps_components_packed,
        SHARD.shard_rows(dev_buf[: bp * cap].view(bp, cap), mesh),
        SHARD.shard_rows(dev_buf[bp * cap :].view(torch.float32), mesh),
    )
    return labels.cpu().numpy()[flat_row, within]


def _epscc_assign_keys(cluster_keys, color_of_pair, starts, sizes_masked,
                       eps, key_base, device, mesh=None):
    """Assign eps-CC cluster keys for every non-zero run, in place.

    On CUDA every bucket goes through the eps-sweep kernel; on the CPU
    through the native grid union-find (`_epscc_native_on`) or the plain
    sweep.  All give run-local minimum-member labels, and the key arithmetic
    (key_base + row * (cap+1) + label over the same bucket grid) is shared,
    so the keys are identical.  Returns the advanced key_base.
    """
    cuda = torch.device(device).type == "cuda"
    use_native = not cuda and _epscc_native_on()
    for cap, ids in _bucketize(sizes_masked, _BUCKETS).items():
        with stage_timer("epscc.labels"):
            labels = None
            if use_native:
                labels = native.epscc_labels_runs(
                    color_of_pair, starts[ids], sizes_masked[ids], eps[ids]
                )
            if labels is None:
                labels = _epscc_labels_device(
                    color_of_pair, starts[ids], sizes_masked[ids], eps[ids], cap, device, mesh
                )
        flat_pos, flat_row, _ = native.flat_run_positions(starts[ids], sizes_masked[ids])
        cluster_keys[flat_pos] = key_base + flat_row * np.int64(cap + 1) + labels
        key_base += np.int64(len(ids)) * (cap + 1)
    return key_base


def tier1_table(
    image_rgb: np.ndarray,
    seg_map: np.ndarray,
    seg_quality: np.ndarray,
    device,
    *,
    seed: int = 42,
    weighted: bool = True,
    split_method: str = "kmeans",
    split_margin: float = 1.0,
    weighted_split: bool = False,
    device_pairs=None,
    mesh=None,
) -> dict | None:
    """Tier-1 clustering as a pair/cluster TABLE (no canvas paint).

    With `device_pairs` (an ops.pairs.DevicePairTable built from the same
    seg_map), the pair table comes from the device sort instead of the host
    radix pack, the black repair runs on the table only, and `inverse` stays
    None: the per-pixel state lives on the device and the final paint is a
    gather there (codec.tiers23_palette_indices).

    Returns None when no pixel has a segment; otherwise a dict:
      seg_of_pair     (n_pairs,) int32   segment id per unique pair
      cluster_of_pair (n_pairs,) int64   dense tier-1 cluster id per pair
      cluster_colors  (n_clusters, 3) u8 truncated cluster means
      inverse         (n_masked,) int64  pair row per masked pixel (row-major),
                                         None with device_pairs
      mask            (h, w) bool        seg_map > 0
      pair_weights    (n_pairs,) f64     pixel multiplicity per pair
      device_pairs                       the argument
      repair_remap    (n_pre,) int64     pre-repair pair row -> repaired row,
                                         None without device_pairs
    """
    with stage_timer("t1.pairs"):
        mask = seg_map > 0
        # Black repair in C++: black pairs take their segment's darkest
        # non-black color; the pair table compacts in place.
        # Without the runtime: numpy's unique and repair (the same table).
        repair_remap = None
        packed = None if device_pairs is not None else native.pack_pairs(image_rgb, seg_map)
        if device_pairs is not None:
            uniq, counts = device_pairs.uniq.copy(), device_pairs.counts.copy()
            inverse = None
            if len(uniq) == 0:
                return None
            m, repair_remap = native.black_repair_pairs(uniq, counts, None, return_remap=True)
        elif packed is not None:
            uniq, inverse, counts = packed
            if len(uniq) == 0:
                return None
            m = native.black_repair_pairs(uniq, counts, inverse)
        if device_pairs is not None or packed is not None:
            counts = counts[:m]
            seg_of_pair, color_of_pair, colors = native.split_pair_uniq(uniq[:m])
        else:
            seg_of_pair, color_of_pair, inverse = _pairs_numpy(image_rgb, seg_map)
            if len(seg_of_pair) == 0:
                return None
            seg_of_pair, color_of_pair, inverse = _black_repair_numpy(
                seg_of_pair, color_of_pair, inverse
            )
            counts = np.bincount(inverse, minlength=len(seg_of_pair))
            colors = _unpack(color_of_pair).astype(np.float32)
    n_pairs = len(seg_of_pair)

    # Pair table is sorted by (segment, color): contiguous runs per segment.
    seg_ids, starts, sizes = _runs_of_sorted(seg_of_pair)
    qualities = seg_quality[seg_ids]
    # Reference n_colors counts the bbox-crop black too.
    n_colors_law = sizes + 1
    eps = 128.0 - 1.28 * qualities
    eps[eps == 0] = 1.0
    max_colors = np.ceil(
        (n_colors_law - n_colors_law * qualities / 100.0) / qualities
    ).astype(np.int64)
    max_colors[max_colors == 0] = 1

    cluster_keys = np.full(n_pairs, -1, np.int64)
    key_base = np.int64(0)

    with stage_timer("t1.epscc"):
        big = np.flatnonzero(sizes >= cfg.KMEANS_SWITCH_COLORS)
        small_sizes = sizes.copy()
        small_sizes[big] = 0
        key_base += _assign_trivial_runs(
            cluster_keys, colors, starts, small_sizes, eps, key_base
        )
        key_base = _epscc_assign_keys(
            cluster_keys, color_of_pair, starts, small_sizes, eps,
            key_base, device, mesh,
        )
        if len(big):
            with stage_timer("epscc.kmeans"):
                labs = CL.kmeans_host_many(
                    [
                        (
                            colors[starts[p] : starts[p] + sizes[p]],
                            cfg.kmeans_n_clusters(int(sizes[p]), qualities[p]),
                        )
                        for p in big
                    ],
                    device, seed=seed,
                )
            for pid, lab in zip(big, labs):
                s, n = starts[pid], sizes[pid]
                cluster_keys[s : s + n] = key_base + lab
                key_base += np.int64(lab.max()) + 1
        _, cluster_of_pair = _unique_inverse(cluster_keys)
        next_cluster = int(cluster_of_pair.max()) + 1

    pair_weights = counts.astype(np.float64)
    with stage_timer("t1.split"):
        pair_max_colors = np.repeat(max_colors, sizes)
        cluster_of_pair, next_cluster = _split_oversized_batched(
            colors, cluster_of_pair, pair_max_colors, next_cluster, seed, device,
            method=split_method, margin=split_margin,
            weights=pair_weights if _weighted_split_on(weighted_split) else None,
            colors_dev_pre=None if device_pairs is None else device_pairs.colors_dev,
            mesh=mesh,
        )

    with stage_timer("t1.means"):
        cluster_colors = _cluster_means_u8(
            cluster_of_pair, color_of_pair, pair_weights if weighted else None,
            next_cluster,
        )
    return {
        "seg_of_pair": seg_of_pair,
        "cluster_of_pair": cluster_of_pair,
        "cluster_colors": cluster_colors,
        "inverse": inverse,
        "mask": mask,
        "pair_weights": pair_weights,
        "device_pairs": device_pairs,
        "repair_remap": repair_remap,
    }


def tier1_colors(
    image_rgb: np.ndarray,
    seg_map: np.ndarray,
    seg_quality: np.ndarray,
    device,
    *,
    seed: int = 42,
    weighted: bool = True,
    split_method: str = "kmeans",
    split_margin: float = 1.0,
    weighted_split: bool = False,
) -> np.ndarray:
    """Per-pixel tier-1 colours: (h, w, 3) uint8, black where seg_map == 0
    (the tier-1 table painted onto a canvas)."""
    table = tier1_table(
        image_rgb, seg_map, seg_quality, device, seed=seed, weighted=weighted,
        split_method=split_method, split_margin=split_margin,
        weighted_split=weighted_split,
    )
    out = np.zeros_like(np.asarray(image_rgb, np.uint8))
    if table is not None:
        paint_table(table, out)
    return out


def paint_table(table: dict, out: np.ndarray) -> None:
    """Paint a host tier-1 table's cluster colours onto the (h, w, 3) uint8
    canvas `out` at its masked pixels."""
    if not native.paint_masked_colors(
        table["cluster_colors"], table["cluster_of_pair"], table["inverse"], table["mask"], out
    ):
        out[table["mask"]] = table["cluster_colors"][table["cluster_of_pair"][table["inverse"]]]


def cluster_color_maps_many(
    colors_list: list,
    sel_list: list,
    quality_list: list,
    out_list: list,
    device,
    *,
    seed: int = 42,
    weighted: bool = True,
    split_method: str = "kmeans",
    split_margin: float = 1.0,
    weighted_split: bool = False,
    mesh=None,
) -> list:
    """Tier-2/3 colour-map clustering of many problems in one pooled table.

    Problem i is (colors_list[i] (h, w, 3) uint8, sel_list[i] (h, w) bool,
    quality_list[i]): the palette of colors[sel] is clustered with black
    pinned (`cluster_pair_table`), and the mapped colours are painted into
    out_list[i] ((h, w, 3) uint8; an entry may repeat when problems share a
    canvas) at the sel pixels.  Returns out_list.
    """
    n_prob = len(colors_list)
    if not len(sel_list) == len(quality_list) == len(out_list) == n_prob:
        raise ValueError("colors_list, sel_list, quality_list and out_list differ in length")
    with stage_timer("t23.pairs"):
        keys = np.empty(sum(int(np.prod(np.shape(sel))) for sel in sel_list), np.int64)
        pixel_counts = []
        off = 0
        for i in range(n_prob):
            n = native.pack_sel_keys(colors_list[i], sel_list[i], i, keys, off)
            if n is None:
                c = colors_list[i][sel_list[i]].astype(np.int64)
                n = len(c)
                keys[off : off + n] = np.int64(i) << 24 | (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
            pixel_counts.append(n)
            off += n
        if off == 0:
            return out_list
        uniq, inverse, pair_pixel_counts = _unique_inverse(keys[:off], return_counts=True)

    pair_colors = cluster_pair_table(
        uniq, pair_pixel_counts, quality_list, device, seed=seed,
        split_method=split_method, split_margin=split_margin,
        weighted_split=weighted_split, weighted=weighted, mesh=mesh,
    )
    off = 0
    for i, cnt in enumerate(pixel_counts):
        inv = inverse[off : off + cnt]
        if not native.paint_masked_colors(pair_colors, None, inv, sel_list[i], out_list[i]):
            out_list[i][sel_list[i]] = pair_colors[inv]
        off += cnt
    return out_list


def cluster_pair_table(
    uniq: np.ndarray,
    weights: np.ndarray | None,
    quality_list,
    device,
    *,
    seed: int = 42,
    split_method: str = "kmeans",
    split_margin: float = 1.0,
    weighted_split: bool = False,
    weighted: bool = True,
    mesh=None,
) -> np.ndarray:
    """Cluster a pooled, deduped (problem, color) pair table.

    `uniq` is the sorted int64 key table `prob << 24 | packed_rgb`; `weights`
    the per-pair pixel multiplicities; `quality_list` maps problem id ->
    quality.  Black pairs are pinned (never clustered, counted by the
    n-colors law).  Returns the (n_pairs, 3) uint8 output color per pair.
    """
    prob_of_pair = (uniq >> 24).astype(np.int32)
    color_of_pair = (uniq & 0xFFFFFF).astype(np.int32)
    colors = _unpack(color_of_pair).astype(np.float32)
    n_pairs = len(uniq)

    prob_ids, starts, sizes = _runs_of_sorted(prob_of_pair)
    # n counts black even when absent from the pixels (the canvas background
    # black joins the merged palette).
    first_key = color_of_pair[starts]
    has_black = first_key == 0  # black (0) sorts first in a run
    n_black_incl = sizes + (~has_black)
    qualities = np.asarray([quality_list[p] for p in prob_ids], np.float64)
    eps = 128.0 - 1.28 * qualities
    eps[eps == 0] = 1.0
    max_colors = np.ceil(
        (n_black_incl - n_black_incl * qualities / 100.0) / qualities
    ).astype(np.int64)
    max_colors[max_colors == 0] = 1

    is_black_pair = color_of_pair == 0
    nb_sizes = sizes - has_black
    nb_starts = starts + has_black

    cluster_keys = np.full(n_pairs, -1, np.int64)
    key_base = np.int64(0)

    with stage_timer("t23.epscc"):
        big = np.flatnonzero(nb_sizes >= cfg.KMEANS_SWITCH_COLORS)
        small_sizes = nb_sizes.copy()
        small_sizes[big] = 0
        key_base += _assign_trivial_runs(
            cluster_keys, colors, nb_starts, small_sizes, eps, key_base
        )
        key_base = _epscc_assign_keys(
            cluster_keys, color_of_pair, nb_starts, small_sizes, eps,
            key_base, device, mesh,
        )
        if len(big):
            with stage_timer("epscc.kmeans"):
                labs = CL.kmeans_host_many(
                    [
                        (
                            colors[nb_starts[r] : nb_starts[r] + nb_sizes[r]],
                            cfg.kmeans_n_clusters(int(nb_sizes[r]), qualities[r]),
                        )
                        for r in big
                    ],
                    device, seed=seed,
                )
            for row, lab in zip(big, labs):
                s, m = nb_starts[row], nb_sizes[row]
                cluster_keys[s : s + m] = key_base + lab
                key_base += np.int64(lab.max()) + 1
        # Every black pair is its own singleton cluster (pinned verbatim).
        black_rows = np.flatnonzero(is_black_pair)
        cluster_keys[black_rows] = key_base + np.arange(len(black_rows))
        _, cluster_of_pair = _unique_inverse(cluster_keys)
        next_cluster = int(cluster_of_pair.max()) + 1

    with stage_timer("t23.split"):
        pair_limits = np.repeat(max_colors, sizes)
        split_w = weights if _weighted_split_on(weighted_split) else None
        cluster_of_pair, next_cluster = _split_oversized_batched(
            colors, cluster_of_pair, pair_limits, next_cluster, seed, device,
            method=split_method, margin=split_margin,
            weights=None if split_w is None else split_w.astype(np.float64), mesh=mesh,
        )

    w = weights.astype(np.float64) if (weighted and weights is not None) else None
    cluster_colors = _cluster_means_u8(cluster_of_pair, color_of_pair, w, next_cluster)
    pair_colors = cluster_colors[cluster_of_pair]
    pair_colors[black_rows] = 0
    return pair_colors


def _pca_chunk_ranks(colors, order, starts, sizes, oversized):
    """(pos, flat_row, rank, n): within-cluster ranks of every point of the
    oversized clusters along each cluster's own principal axis (12 rounds of
    batched power iteration, BT.601 luma for degenerate clusters, one global
    lexsort)."""
    n = sizes[oversized].astype(np.int64)
    flat_pos, flat_row, _ = native.flat_run_positions(starts[oversized], sizes[oversized])
    pos = order[flat_pos]
    pts = colors[pos].astype(np.float64)

    m = len(n)
    sums = np.stack(
        [np.bincount(flat_row, weights=pts[:, c], minlength=m) for c in range(3)],
        axis=1,
    )
    mu = sums / n[:, None]
    d = pts - mu[flat_row]
    cov = np.zeros((m, 3, 3))
    for a in range(3):
        for b in range(a, 3):
            s = np.bincount(flat_row, weights=d[:, a] * d[:, b], minlength=m)
            cov[:, a, b] = s
            cov[:, b, a] = s
    v = np.full((m, 3), 0.577350269)
    for _ in range(12):
        v = np.einsum("mij,mj->mi", cov, v)
        nv = np.linalg.norm(v, axis=1, keepdims=True)
        small = nv[:, 0] < 1e-12
        if small.any():
            v[small] = [0.299, 0.587, 0.114]
            nv[small] = 1.0
        v /= nv
    proj = np.einsum("ij,ij->i", d, v[flat_row])

    sidx = np.lexsort((proj, flat_row))  # stable: ties keep color order
    off = np.zeros(m, np.int64)
    np.cumsum(n[:-1], out=off[1:])
    rank = np.empty(len(pos), np.int64)
    rank[sidx] = np.arange(len(pos), dtype=np.int64) - np.repeat(off, n)
    return pos, flat_row, rank, n


def _pca_chunk_init_means(colors, pos, flat_row, rank, n, ks, k_max):
    """(m, k_max, 3) float32 stratified initial centres of the kmeans-mc
    split: the point at the centre rank of each of a cluster's ks[i] chunks
    along its principal axis (rows >= ks[i] stay zero; the k-means masks
    them).  Real points, not chunk means, so isolated outlier colours keep a
    centre."""
    m = len(n)
    chunk = rank * ks[flat_row] // n[flat_row]
    # Centre rank of chunk c: floor((c + 0.5) * n / k).
    target = (2 * chunk + 1) * n[flat_row] // (2 * ks[flat_row])
    is_center = rank == target
    key = flat_row * k_max + chunk
    inits = np.zeros((m * k_max, 3), np.float32)
    inits[key[is_center]] = colors[pos[is_center]]
    return inits.reshape(m, k_max, 3)


def _split_oversized_mediancut(colors, cluster_of_pair, pair_max_colors, next_cluster):
    """Split oversized clusters by recursive median cut, with no device work.

    Level-synchronous binary cuts: every oversized cluster is ranked along
    its own principal axis (`_pca_chunk_ranks`) and cut at the median, the
    lower half taking ceil(n/2); children above their limit are cut again at
    the next level.  Sizes halve per level, so the max_colors_per_cluster law
    holds after ceil(log2(n/max)) levels (clusters of <= 2 colours are never
    split, as in the k-means path).  Ids are compacted once at the end.
    """
    active = None  # None: every position (level 0)
    any_split = False
    for _level in range(40):  # sizes halve per level: 2^40 rows is unreachable
        if active is None:
            order = native.argsort_i64(cluster_of_pair)
        else:
            if len(active) == 0:
                break
            order = active[native.argsort_i64(cluster_of_pair[active])]
        _, starts, sizes = _runs_of_sorted(cluster_of_pair[order])
        limits = pair_max_colors[order[starts]]
        oversized = np.flatnonzero((sizes > limits) & (sizes > 2))
        if len(oversized) == 0:
            break
        any_split = True
        pos, flat_row, rank, n = _pca_chunk_ranks(colors, order, starts, sizes, oversized)
        child = rank >= (n[flat_row] + 1) // 2
        cluster_of_pair[pos] = next_cluster + flat_row * 2 + child
        next_cluster += 2 * len(n)
        active = pos  # only just-split children can still be oversized
    if any_split:
        _, cluster_of_pair = _unique_inverse(cluster_of_pair)
        next_cluster = int(cluster_of_pair.max()) + 1
    return cluster_of_pair, next_cluster


def _kmeans_bucket(colors_dev, order_dev, starts_b, sizes_b, ks_b, cap, k_max, seed,
                   inits=None, weights_dev=None, mesh=None):
    """Device k-means over runs of the ORDER permutation: row r's points are
    colors[order[starts_b[r] + j]], j < sizes_b[r], gathered on the device from
    the level's colors and order tensors.  inits: (B, k_max, 3) initial
    centres (kmeans-mc), else k-means++ or the seeded random init;
    weights_dev: float32 per-pair weights gathered alike (weighted Lloyd).
    With `mesh` the rows, padded to a multiple of its data axis, split over
    its data devices.  Returns (B, cap) labels."""
    dev = colors_dev.device
    b = len(starts_b)
    bp = SHARD.pad_rows(b, mesh)
    ss = torch.from_numpy(np.stack([SHARD.pad_to(starts_b, bp),
                                    SHARD.pad_to(sizes_b, bp)]).astype(np.int64)).to(dev)
    within = torch.arange(cap, device=dev)[None, :]
    valid = within < ss[1][:, None]
    pos = torch.where(valid, ss[0][:, None] + within, torch.zeros_like(within))
    idx = order_dev[pos]
    pts = colors_dev[idx].float() * valid[..., None]
    w = None if weights_dev is None else weights_dev[idx] * valid
    init = None if inits is None else torch.from_numpy(SHARD.pad_to(inits, bp)).to(dev)
    rows = [SHARD.shard_rows(x, mesh) for x in (pts, valid, SHARD.pad_to(np.asarray(ks_b), bp))]
    labels = DISPATCH.call(
        CL.kmeans_rows, *rows, k_max=k_max, iters=10, seed=seed,
        plusplus=k_max <= cfg.KMEANSPP_MAX_K,
        init_centers=None if init is None else SHARD.shard_rows(init, mesh),
        weights=None if w is None else SHARD.shard_rows(w, mesh),
    )
    return labels[:b].cpu().numpy()


def _split_oversized_batched(colors, cluster_of_pair, pair_max_colors,
                             next_cluster, seed, device, method="kmeans",
                             margin=1.0, weights=None, colors_dev_pre=None, mesh=None):
    """Split clusters above their per-segment max size, level-synchronously.

    Each level gathers ALL oversized clusters, buckets them by size and runs
    one batched k-means per bucket (method "kmeans"); "hybrid" first resolves
    clusters of <= 64 colors with host PCA median cuts run to limit/margin
    within the level; "kmeans-mc" starts each k-means from host PCA-chunk
    points instead of k-means++; "mediancut" splits by host median cuts
    alone (`_split_oversized_mediancut`, no device work).  Only pairs of
    just-split clusters can still be oversized, so each level sorts that
    frontier only; ids are compacted once
    after the loop (split keys exceed every live id, so the numbering equals
    a per-level compaction).

    The colors table is the same at every level and goes to the device once;
    `colors_dev_pre` is that table where it is there already (the device pair
    table's post-repair colors, any integer or float dtype, at least
    len(colors) rows).

    `weights` (per-pair pixel counts, the weighted split) weight the device
    Lloyd k-means; the paths without a weighted form warn once and run
    unweighted, as in the JAX package.

    The JAX package's overrides from the environment are read here, where it
    reads them: RHCCQ_SPLIT_METHOD replaces `method`; RHCCQ_HYBRID_CUTOFF the
    hybrid cutoff (64); the hybrid cuts' margin is RHCCQ_HYBRID_MARGIN, else
    RHCCQ_SPLIT_MARGIN, else `margin`; the k-means margin RHCCQ_SPLIT_MARGIN,
    else `margin`.
    """
    method = os.environ.get("RHCCQ_SPLIT_METHOD") or method
    if method == "mediancut":
        if weights is not None:
            _warn_weights_dropped("split_method='mediancut'")
        with stage_timer("split.lum"):
            return _split_oversized_mediancut(colors, cluster_of_pair, pair_max_colors, next_cluster)
    if method not in ("kmeans", "hybrid", "kmeans-mc"):
        raise ValueError(f"unknown split_method {method!r}")
    active = None
    any_split = False
    colors_dev = colors_dev_pre
    weights_dev = None
    for _level in range(8):
        if active is None:
            order = native.argsort_i64(cluster_of_pair)
        else:
            if len(active) == 0:
                break
            order = active[native.argsort_i64(cluster_of_pair[active])]
        _, starts, sizes = _runs_of_sorted(cluster_of_pair[order])
        limits = pair_max_colors[order[starts]]
        oversized = np.flatnonzero((sizes > limits) & (sizes > 2))
        if len(oversized) == 0:
            break
        any_split = True
        next_active = []
        key_base = np.int64(next_cluster)

        if method == "hybrid":
            cutoff = int(os.environ.get("RHCCQ_HYBRID_CUTOFF") or _HYBRID_CUTOFF)
            m_h = float(
                os.environ.get("RHCCQ_HYBRID_MARGIN")
                or os.environ.get("RHCCQ_SPLIT_MARGIN")
                or margin
            )
            tiny = oversized[sizes[oversized] <= cutoff]
            if len(tiny):
                if weights is not None:
                    _warn_weights_dropped("hybrid's tiny median cuts")
                flat_pos_t, _, _ = native.flat_run_positions(starts[tiny], sizes[tiny])
                tiny_pos = order[flat_pos_t]
                # Sizes halve per cut: log2(cutoff) + 2 rounds reach the limit.
                n_cuts = max(12, cutoff.bit_length() + 2)
                for _cut in range(n_cuts):
                    o_t = tiny_pos[native.argsort_i64(cluster_of_pair[tiny_pos])]
                    _, st_t, sz_t = _runs_of_sorted(cluster_of_pair[o_t])
                    lim_t = np.maximum(
                        1, -(-pair_max_colors[o_t[st_t]] // max(m_h, 1.0))
                    ).astype(np.int64)
                    ov_t = np.flatnonzero((sz_t > lim_t) & (sz_t > 2))
                    if len(ov_t) == 0:
                        break
                    pos2, row2, rank2, n2 = _pca_chunk_ranks(
                        colors, o_t, st_t, sz_t, ov_t
                    )
                    child = rank2 >= (n2[row2] + 1) // 2
                    cluster_of_pair[pos2] = key_base + row2 * 2 + child
                    key_base += np.int64(2 * len(ov_t))
                    tiny_pos = pos2
                oversized = oversized[sizes[oversized] > cutoff]
                if len(oversized) == 0:
                    next_cluster = int(key_base)
                    active = np.empty(0, np.int64)
                    continue

        # n_splits law: min(max(2, ceil(n*margin/max)), n).
        n = sizes[oversized]
        lim = np.maximum(limits[oversized], 1)
        m_eff = float(os.environ.get("RHCCQ_SPLIT_MARGIN") or margin)
        ks = np.minimum(np.maximum(2, -(-(n * m_eff).astype(np.int64) // lim)), n)

        inits = None
        if method == "kmeans-mc":
            if weights is not None:
                _warn_weights_dropped("split_method='kmeans-mc'")
            pos_mc, row_mc, rank_mc, n_mc = _pca_chunk_ranks(colors, order, starts, sizes, oversized)
            inits = _pca_chunk_init_means(
                colors, pos_mc, row_mc, rank_mc, n_mc, ks.astype(np.int64), _pad_kmax(int(ks.max()))
            )

        huge_rows = np.flatnonzero(sizes[oversized] > _SPLIT_CAPS[-1])
        if len(huge_rows):
            if weights is not None:
                _warn_weights_dropped(">65536-color host k-means")
            labs = CL.kmeans_host_many(
                [
                    (
                        colors[order[starts[oversized[r]] : starts[oversized[r]] + sizes[oversized[r]]]],
                        int(ks[r]),
                    )
                    for r in huge_rows
                ],
                device, seed=seed,
            )
            for row, lab in zip(huge_rows, labs):
                cid = oversized[row]
                s, m = starts[cid], sizes[cid]
                cluster_of_pair[order[s : s + m]] = key_base + lab
                key_base += np.int64(lab.max()) + 1
                next_active.append(order[s : s + m])
        with stage_timer("split.kmeans"):
            if colors_dev is None:
                colors_dev = torch.from_numpy(colors).to(device)
            order_dev = torch.from_numpy(order).to(device)
            if weights is not None and weights_dev is None:
                # float32, as the JAX package uploads them.
                weights_dev = torch.from_numpy(weights.astype(np.float32)).to(device)
            for cap, rows in _bucketize(sizes[oversized], _SPLIT_CAPS).items():
                ids = oversized[rows]
                k_max = _pad_kmax(int(ks[rows].max()))
                labels = _kmeans_bucket(
                    colors_dev, order_dev, starts[ids], sizes[ids], ks[rows], cap,
                    k_max, seed, None if inits is None else inits[rows][:, :k_max],
                    weights_dev if inits is None else None, mesh,
                )
                flat_pos, flat_row, within = native.flat_run_positions(
                    starts[ids], sizes[ids]
                )
                cluster_of_pair[order[flat_pos]] = (
                    key_base
                    + flat_row * (k_max + 1)
                    + labels[flat_row, within].astype(np.int64)
                )
                key_base += np.int64(len(ids)) * (k_max + 1)
                next_active.append(order[flat_pos])
        next_cluster = int(key_base)
        active = np.concatenate(next_active) if next_active else np.empty(0, np.int64)
    if any_split:
        _, cluster_of_pair = _unique_inverse(cluster_of_pair)
        next_cluster = int(cluster_of_pair.max()) + 1
    return cluster_of_pair, next_cluster
