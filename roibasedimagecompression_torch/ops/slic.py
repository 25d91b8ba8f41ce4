"""Masked SLIC superpixels as 5-D k-means on the device.

CIELAB color (blurred) plus compactness-scaled coordinates, Lloyd iterations
with early exit, then connectivity enforcement on the host runtime.  Regions
are grouped by padded shape; each bucket runs one batched core call.  The
assign step is the hand-written kernel `ops/cuda/slic_assign.py` (its plain
version on the CPU) in the distance form the JAX package picks, read per
call from `RHCCQ_SLIC_PALLAS` as the JAX package reads it: "1" gives the
Pallas kernel's direct differences (invalid centres carry the 1e6 sentinel),
anything else, or nothing, the default expanded form |p|^2 + |c|^2 - 2 p.c
(invalid centres masked).  Pixels are padded to a 2048 grid in both forms;
padding is outside the mask, so it changes no id and no centre.

The features (Lab, the 9-tap blur) are the JAX package's to the bit, and
the centre update adds in float32 in the order of the JAX package's CPU run
(`_centre_sums`): XLA sums a one-hot matrix product over pixel chunks, and
Eigen splits each chunk's contraction into shards across the host's threads.
That order depends on the host's thread count; the port follows an 8-thread
host (the hosts of this project's test runs and of the H100 machine have 8
cores), on the CPU and on the card alike.

Output convention matches masked skimage slic: labels 1..n inside the mask,
0 outside.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops.cuda import slic_assign as SA
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import dispatch as DISPATCH
from roibasedimagecompression_torch.utils.timing import stage_timer

_TILE = 2048  # pixel padding grid of the JAX Pallas mode
_SENTINEL = 1e6


# Eigen's contraction of one pixel chunk on an 8-thread host: the chunk splits
# into 8 shards, each shard into blocks of `_eigen_kc(shard)` pixels.
_EIGEN_SHARDS = 8
_EIGEN_MAX_KC = 320
_EIGEN_PEEL = 8


def _eigen_kc(k: int) -> int:
    """Eigen's depth block for a k-deep product (its kc blocking rule, with
    the largest block 320), read off the JAX package's CPU sums."""
    if k <= _EIGEN_MAX_KC or k % _EIGEN_MAX_KC == 0:
        return min(k, _EIGEN_MAX_KC)
    return _EIGEN_MAX_KC - _EIGEN_PEEL * (
        (_EIGEN_MAX_KC - k % _EIGEN_MAX_KC) // (_EIGEN_PEEL * (k // _EIGEN_MAX_KC + 1))
    )


def _block_sums(x: torch.Tensor, rows: torch.Tensor, n_rows: int, loop: bool = False) -> torch.Tensor:
    """(n_rows, d) float32: x[blk, j] added into row rows[blk, j], the pixels
    of each block one after another in float32 (rows of two blocks never
    meet).  On the CPU numpy's unbuffered `add.at` adds element by element in
    order; on the card (or with `loop`) pixel j of every block goes in at
    once, kc launches in all."""
    d = x.shape[-1]
    if x.device.type == "cpu" and not loop:
        acc = np.zeros((n_rows, d), np.float32)
        np.add.at(acc, rows.reshape(-1).numpy(), x.reshape(-1, d).numpy())
        return torch.from_numpy(acc)
    acc = torch.zeros((n_rows, d), dtype=torch.float32, device=x.device)
    x, rows = x.transpose(0, 1).contiguous(), rows.t().contiguous()
    for j in range(x.shape[0]):
        acc.index_add_(0, rows[j], x[j])
    return acc


def _centre_sums(ids: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor,
                 m: int, chunk: int, k: int) -> torch.Tensor:
    """(B, K, d) float32 sums of the valid pixels' features per centre, added
    in the order of the JAX package's one-hot update on the CPU.

    XLA scans the m pixels in chunks (running sum += chunk sum).  Eigen
    contracts a chunk as 8 shards of chunk/8 pixels; each shard adds its
    depth blocks in turn (shard += block), a block adds its pixels one after
    another from zero, and the shards combine as ((s0 + s1) + (s2 + s3)) +
    ((s4 + s5) + (s6 + s7)).  A one-hot product adds each feature exactly, so
    this is those float32 additions and nothing else.  ids, valid: (B, MP)
    with MP at most the chunks' span; pixels at or beyond m are never valid.
    """
    b, mp = ids.shape
    dev = feats.device
    nf = feats.shape[-1]
    n_chunks = -(-m // chunk)
    span = n_chunks * chunk
    shard = chunk // _EIGEN_SHARDS
    kc = _eigen_kc(shard)
    n_kc = -(-shard // kc)
    x = torch.where(valid[..., None], feats, torch.zeros((), device=dev))
    i = ids.long()
    if span > mp:
        x = torch.cat([x, x.new_zeros((b, span - mp, nf))], dim=1)
        i = torch.cat([i, i.new_zeros((b, span - mp))], dim=1)
    x = x.reshape(b * n_chunks * _EIGEN_SHARDS, shard, nf)
    i = i.reshape(b * n_chunks * _EIGEN_SHARDS, shard)
    if n_kc * kc > shard:
        x = torch.cat([x, x.new_zeros((x.shape[0], n_kc * kc - shard, nf))], dim=1)
        i = torch.cat([i, i.new_zeros((i.shape[0], n_kc * kc - shard))], dim=1)
    n_blocks = x.shape[0] * n_kc
    # Row of (block, centre) in the accumulator, for every pixel in order.
    rows = torch.arange(n_blocks, device=dev)[:, None] * k + i.reshape(n_blocks, kc)
    acc = _block_sums(x.reshape(n_blocks, kc, nf), rows, n_blocks * k)
    acc = acc.view(b, n_chunks, _EIGEN_SHARDS, n_kc, k, nf)
    s = acc[:, :, :, 0]
    for q in range(1, n_kc):
        s = s + acc[:, :, :, q]
    d = ((s[:, :, 0] + s[:, :, 1]) + (s[:, :, 2] + s[:, :, 3])) + (
        (s[:, :, 4] + s[:, :, 5]) + (s[:, :, 6] + s[:, :, 7])
    )
    out = d[:, 0]
    for c in range(1, n_chunks):
        out = out + d[:, c]
    return out


def direct_form() -> bool:
    """True for the Pallas kernel's direct form (`RHCCQ_SLIC_PALLAS=1`),
    False for the JAX package's default expanded form."""
    return os.environ.get("RHCCQ_SLIC_PALLAS") == "1"


def _slic_core_batch(
    rgb: torch.Tensor,
    mask: torch.Tensor,
    centers_yx: torch.Tensor,
    center_valid: torch.Tensor,
    step: torch.Tensor,
    *,
    iters: int = 10,
    compactness: float = 10.0,
    sigma: float = 1.0,
) -> torch.Tensor:
    """Batched SLIC core: uint8 RGB in, uint8 centre ids out.

    Args:
      rgb: (B, H, W, 3) uint8 region crops (zeros beyond each bbox).
      mask: (B, H, W) bool.
      centers_yx: (B, K, 2) int64 grid-initialized coordinates, K <= 256.
      center_valid: (B, K) bool; padding rows False.
      step: (B,) float32 SLIC grid spacing S.
    Returns:
      (B, H, W) uint8 centre ids inside the mask, 255 outside.
    """
    b, h, w, _ = rgb.shape
    k = centers_yx.shape[1]
    dev = rgb.device
    lab = CONV.gaussian_blur(COL.rgb_to_lab(rgb), sigma)

    # A true division: `scalar / tensor` in torch is a reciprocal and a product.
    ratio = torch.full_like(step, compactness, dtype=torch.float32) / step.float()  # (B,)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None].expand(b, h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :].expand(b, h, w)
    feats = torch.cat(
        [lab, (yy * ratio[:, None, None])[..., None], (xx * ratio[:, None, None])[..., None]],
        dim=-1,
    ).reshape(b, h * w, 5)
    valid = mask.reshape(b, h * w)

    bi = torch.arange(b, device=dev)[:, None]
    c_lab = lab[bi, centers_yx[..., 0], centers_yx[..., 1]]  # (B, K, 3)
    init = torch.cat([c_lab, centers_yx.float() * ratio[:, None, None]], dim=-1)
    cv = center_valid[..., None]
    centers = torch.where(cv, init, torch.full_like(init, _SENTINEL))

    m = h * w
    pad = (-m) % _TILE
    if pad:
        feats = torch.cat([feats, feats.new_zeros((b, pad, 5))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    feats = feats.contiguous()
    direct = direct_form()
    # The JAX package's update chunk: its Pallas tile, else min(16384, m).
    chunk = _TILE if direct else min(16384, m)

    if direct:
        def assign(c):
            return SA.slic_assign(feats, torch.where(cv, c, torch.full_like(c, _SENTINEL)).contiguous())
    else:
        def assign(c):
            return SA.slic_assign_expanded(feats, c.contiguous(), center_valid)

    def update(ids, c):
        sums = _centre_sums(ids, feats, valid, m, chunk, k)
        counts = torch.zeros((b, k), dtype=torch.float32, device=dev)
        counts.scatter_add_(1, ids.long(), valid.float())  # integers: exact in any order
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        return torch.where(counts[..., None] > 0, new, c)

    # Early-exit Lloyd: once no id changes the update is a fixed point, so
    # stopping is identical to running all iterations (rows that converge
    # first stay fixed while the others finish).
    prev = torch.full((b, feats.shape[1]), -1, dtype=torch.int32, device=dev)
    for _ in range(iters):
        ids = assign(centers)
        centers = update(ids, centers)
        changed = bool((ids != prev).any())
        prev = ids
        if not changed:
            break
    out = assign(centers)[:, :m]
    out = torch.where(mask.reshape(b, m), out, torch.full_like(out, 255))
    return out.reshape(b, h, w).to(torch.uint8)


def _pad_dim(n: int) -> int:
    """SLIC bucket dim: tiers {64, 128, 256} up to 256, then multiples of 64."""
    if n <= 64:
        return 64
    if n <= 128:
        return 128
    if n <= 256:
        return 256
    return -(-n // 64) * 64


def _prepare_centers(mask: np.ndarray, n_segments: int):
    """Grid centres at spacing S = sqrt(area/n), snapped into the mask."""
    h, w = mask.shape
    area = int(mask.sum())
    n_segments = max(1, int(n_segments))
    step = float(np.sqrt(area / n_segments))
    ys = np.arange(step / 2, h, step)
    xs = np.arange(step / 2, w, step)
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    grid_int = np.clip(np.round(grid).astype(np.int64), 0, [h - 1, w - 1])
    inside = mask[grid_int[:, 0], grid_int[:, 1]]
    if inside.any():
        centers_yx = grid_int[inside]
    else:
        # Snap every grid point to its nearest mask pixel.
        mask_yx = np.argwhere(mask)
        d = np.abs(mask_yx[None, :, 0] - grid_int[:, :1]).astype(np.float64) ** 2 + (
            np.abs(mask_yx[None, :, 1] - grid_int[:, 1:2]) ** 2
        )
        centers_yx = np.unique(mask_yx[np.argmin(d, axis=1)], axis=0)
    if len(centers_yx) > n_segments:
        take = np.linspace(0, len(centers_yx) - 1, n_segments).astype(np.int64)
        centers_yx = centers_yx[np.unique(take)]
    if len(centers_yx) > 255:
        # uint8 ids keep 255 as the outside-mask sentinel.
        take = np.linspace(0, len(centers_yx) - 1, 255).astype(np.int64)
        centers_yx = centers_yx[np.unique(take)]
    return centers_yx.astype(np.int32), step


def _compact_labels(labels: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Relabel to 1..n inside the mask, 0 outside."""
    out = np.zeros(labels.shape, np.int32)
    vals = labels[mask]
    if vals.size == 0:
        return out
    _, inv = np.unique(vals, return_inverse=True)
    out[mask] = inv.astype(np.int32) + 1
    return out


def slic(
    image_rgb: np.ndarray,
    mask: np.ndarray,
    n_segments: int,
    device,
    compactness: float = 10.0,
    sigma: float = 1.0,
    iters: int = 10,
    min_size_factor: float = 0.5,
) -> np.ndarray:
    """Masked SLIC of one region: (h, w, 3) uint8 + (h, w) bool -> (h, w)
    int32 labels (0 outside the mask, 1..n inside); `slic_many` at one row,
    so kernel 1 runs at (1, MP, K)."""
    return slic_many(
        [image_rgb], [mask], [n_segments], device,
        compactness=compactness, sigma=sigma, iters=iters, min_size_factor=min_size_factor,
    )[0]


def slic_many(
    images: list,
    masks: list,
    n_segments: list,
    device,
    compactness: float = 10.0,
    sigma: float = 1.0,
    iters: int = 10,
    min_size_factor: float = 0.5,
    sources: list | None = None,
    dbatch=None,
    mesh=None,
) -> list:
    """Batched masked SLIC over many regions.

    Landscape regions are transposed to portrait (exact: distances, updates
    and connectivity are coordinate-order invariant) and grouped by padded
    shape and centre cap (64 or 256).  Rows with a `sources` entry slice their
    crop from the device batch `dbatch`, and their Lloyd loop runs on the
    region-id raster's mask: where two regions of one kind overlap (a small
    ROI region demoted into the non-ROI buffer zone) the raster holds the
    later one, as in the JAX package; the centres and the connectivity pass
    use `masks` on every path.  With `mesh`, a bucket's rows (padded to a
    multiple of its data axis) split over its data devices.  Returns (h_i,
    w_i) int32 label maps (0 outside mask, 1..n inside).
    """
    n = len(images)
    out: list = [None] * n
    if sources is None:
        sources = [None] * n
    k_max = 256
    buckets: dict = {}
    metas: dict = {}
    for i in range(n):
        mask = np.asarray(masks[i], bool)
        transposed = mask.shape[1] > mask.shape[0]
        if transposed:
            mask = mask.T
        h0, w0 = mask.shape
        area = int(mask.sum())
        if area == 0:
            out[i] = np.zeros(np.asarray(masks[i], bool).shape, np.int32)
            continue
        centers_yx, step = _prepare_centers(mask, n_segments[i])
        if len(centers_yx) > k_max:
            raise ValueError(f"SLIC center count {len(centers_yx)} exceeds {k_max}")
        metas[i] = (mask, centers_yx, step, area, transposed)
        k_cap = 64 if len(centers_yx) <= 64 else k_max
        buckets.setdefault((_pad_dim(h0), _pad_dim(w0), k_cap), []).append(i)

    for (ph, pw, k_cap), ids in buckets.items():
        with stage_timer("slic.core"):
            bsz = len(ids)
            rgb_b = torch.zeros((bsz, ph, pw, 3), dtype=torch.uint8, device=device)
            masks_b = np.zeros((bsz, ph, pw), bool)
            cyx = np.zeros((bsz, k_cap, 2), np.int64)
            cval = np.zeros((bsz, k_cap), bool)
            steps = np.ones(bsz, np.float32)
            raster_masks = []
            for row, i in enumerate(ids):
                mask, centers_yx, step, _, transposed = metas[i]
                h0, w0 = mask.shape
                masks_b[row, :h0, :w0] = mask
                if sources[i] is not None and dbatch is not None:
                    rgb_b[row, :h0, :w0], raster = dbatch.crop(sources[i], transposed)
                    raster_masks.append((row, h0, w0, raster))
                else:
                    img = np.asarray(images[i], np.uint8)
                    if transposed:
                        img = np.transpose(img, (1, 0, 2))
                    rgb_b[row, :h0, :w0] = torch.from_numpy(np.ascontiguousarray(img)).to(device)
                kc = len(centers_yx)
                cyx[row, :kc] = centers_yx
                cval[row, :kc] = True
                steps[row] = step
            core_masks = torch.from_numpy(masks_b).to(device)
            for row, h0, w0, raster in raster_masks:
                core_masks[row, :h0, :w0] = raster
            bp = SHARD.pad_rows(bsz, mesh)
            rows = [SHARD.shard_rows(SHARD.pad_to(x, bp), mesh) for x in (
                rgb_b, core_masks, torch.from_numpy(cyx).to(device),
                torch.from_numpy(cval).to(device), torch.from_numpy(steps).to(device))]
            assign_b = DISPATCH.call(
                _slic_core_batch, *rows,
                iters=iters, compactness=float(compactness), sigma=float(sigma),
            )[:bsz].cpu().numpy()
        with stage_timer("slic.conn"):
            labels_rows = _enforce_connectivity_bucket(
                assign_b, masks_b, ids, metas, min_size_factor, device, mesh
            )
        for row, i in enumerate(ids):
            mask, centers_yx, _, _, transposed = metas[i]
            h0, w0 = mask.shape
            if len(centers_yx) > 1:
                lab = labels_rows[row][:h0, :w0]
            else:
                lab = assign_b[row, :h0, :w0]
            compacted = _compact_labels(lab, mask)
            out[i] = compacted.T.copy() if transposed else compacted
    return out


def _enforce_connectivity_bucket(assign_b, masks_b, ids, metas, min_size_factor, device, mesh=None):
    """Split segments into connected fragments and absorb small ones into
    neighbors (skimage _enforce_label_connectivity_cython behavior).

    With the runtime: its union-find fragments and BFS adoption, threaded
    across the bucket rows.  Without it, the JAX package's device form on
    `device`, which gives other labels than the runtime (so other bytes, in
    the JAX package too): 4-connected fragments of equal labels by min-label
    propagation, compacted by np.unique; fragments of at least min_size
    pixels are kept (the largest when none is); every other pixel takes the
    label of its nearest kept pixel by jump flooding (with `mesh`, both
    device steps split the rows over its data devices)."""
    if native.available():
        def one(row):
            _, centers_yx, _, area, _ = metas[ids[row]]
            min_size = max(1, int(min_size_factor * area / len(centers_yx)))
            return native.slic_enforce(assign_b[row], masks_b[row], min_size)

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            return list(pool.map(one, range(len(ids))))
    bsz = len(ids)
    bp = SHARD.pad_rows(bsz, mesh)

    def rows(a: np.ndarray):
        return SHARD.shard_rows(SHARD.pad_to(torch.from_numpy(a).to(device), bp), mesh)

    with stage_timer("slic.frag"):
        frag_b = DISPATCH.call(
            CC.propagate_equal_labels, rows(assign_b.astype(np.int32)), rows(masks_b), connectivity=4
        )[:bsz].cpu().numpy()
    compact_b = np.zeros(assign_b.shape, np.int32)
    keep_b = np.zeros(assign_b.shape, bool)
    for row, i in enumerate(ids):
        mask, centers_yx, _, area, _ = metas[i]
        h0, w0 = mask.shape
        min_size = max(1, int(min_size_factor * area / len(centers_yx)))
        fg = np.zeros(masks_b.shape[1:], bool)
        fg[:h0, :w0] = mask
        _, inv = np.unique(frag_b[row][fg], return_inverse=True)
        sizes = np.bincount(inv)
        keep_frag = sizes >= min_size
        if not keep_frag.any():
            keep_frag[np.argmax(sizes)] = True
        compact_b[row][fg] = inv
        keep_b[row][fg] = keep_frag[inv]
    with stage_timer("slic.adopt"):
        adopted = DISPATCH.call(
            CC.adopt_labels, rows(compact_b), rows(keep_b), rows(masks_b)
        )[:bsz].cpu().numpy()
    return [adopted[row] for row in range(len(ids))]
