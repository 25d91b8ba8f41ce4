"""Region extraction and sub-region segmentation (split score + SLIC).

Regions are connected components of the ROI / non-ROI masks; each region's
split score (color + texture complexity) sets its SLIC segment count through
the logistic window law; SLIC runs at a <= 500 px working resolution and its
labels are upsampled back.  The split score runs batched on the device, one
call per shape bucket; the bucket geometry (zeros beyond the bbox inside a
`_pow2_bucket` window, transposed landscape regions) is part of the result,
because the Sobel, LBP and blur borders see the padded window.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch.ops import cc as CC
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV
from roibasedimagecompression_torch.ops import lbp as LBP
from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops import slic as SLIC
from roibasedimagecompression_torch.ops import xla_order as XO
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import dispatch as DISPATCH
from roibasedimagecompression_torch.utils.timing import stage_timer


@dataclasses.dataclass
class Region:
    """A connected region of the ROI or non-ROI mask."""

    bbox: tuple  # (minr, minc, maxr, maxc), exclusive max
    bbox_mask: np.ndarray  # (bh, bw) bool
    area: int
    kind: str  # "roi" | "nonroi"


def extract_regions(mask: np.ndarray, kind: str, device=None) -> list:
    """Connected components (8-conn) of a binary mask -> Region list
    (`device` runs them without the native runtime; the CPU when None)."""
    labels, num = CC.connected_components(mask, connectivity=8, device=device)
    if num <= 1:
        return []
    stats = CC.component_stats(labels, num)
    areas, bboxes = stats.areas, stats.bboxes
    out = []
    for lab in range(1, num):
        minr, minc, maxr, maxc = bboxes[lab]
        out.append(
            Region(
                bbox=(int(minr), int(minc), int(maxr), int(maxc)),
                bbox_mask=labels[minr:maxr, minc:maxc] == lab,
                area=int(areas[lab]),
                kind=kind,
            )
        )
    return out


def reassign_small_roi(roi_regions: list, nonroi_regions: list, min_size: int):
    """ROI regions below min_size become non-ROI."""
    big = [r for r in roi_regions if r.area >= min_size]
    small = [
        dataclasses.replace(r, kind="nonroi") for r in roi_regions if r.area < min_size
    ]
    return big, nonroi_regions + small


def fuse_adjacent_regions(regions: list, image_shape: tuple, kind: str, device=None) -> list:
    """Merge same-kind regions that touch (8-connectivity): rasterize every
    region onto one canvas and extract its components again.  Returns the
    input list unchanged when nothing fuses."""
    if len(regions) <= 1:
        return regions
    combined = np.zeros(image_shape[:2], bool)
    for r in regions:
        minr, minc, maxr, maxc = r.bbox
        combined[minr:maxr, minc:maxc] |= r.bbox_mask
    fused = extract_regions(combined, kind, device)
    if len(fused) == len(regions):
        return regions
    return fused


def process_regions_with_reassignment(image_rgb: np.ndarray, roi_mask: np.ndarray,
                                      nonroi_mask: np.ndarray, device=None):
    """Region fusion (CodecConfig.region_fusion): extract, reassign small
    regions both ways (small ROI regions become non-ROI and small non-ROI
    regions ROI), then fuse each kind's touching regions.  The minimum size
    counts pixels here, min_region_size(h * w), where the main path counts
    h * w * 3 elements."""
    h, w = image_rgb.shape[:2]
    min_size = cfg.min_region_size(h * w)
    roi_regions = extract_regions(roi_mask, "roi", device)
    nonroi_regions = extract_regions(nonroi_mask, "nonroi", device)

    new_roi = [r for r in roi_regions if r.area >= min_size]
    new_nonroi = [dataclasses.replace(r, kind="nonroi") for r in roi_regions if r.area < min_size]
    new_nonroi += [r for r in nonroi_regions if r.area >= min_size]
    new_roi += [dataclasses.replace(r, kind="roi") for r in nonroi_regions if r.area < min_size]

    new_roi = fuse_adjacent_regions(new_roi, image_rgb.shape, "roi", device)
    new_nonroi = fuse_adjacent_regions(new_nonroi, image_rgb.shape, "nonroi", device)
    return new_roi, new_nonroi


class DeviceBatch:
    """Same-shape image batch and two region-id rasters on the device.

    ROI and non-ROI regions can overlap in the 3-px buffer zone, hence one
    raster per kind.  Crops are sliced from these tensors, so the batch
    crosses to the device once per encode.
    """

    def __init__(self, images: np.ndarray, reg_nonroi: np.ndarray,
                 reg_roi: np.ndarray, device):
        self.img = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.reg = (
            torch.from_numpy(np.ascontiguousarray(reg_nonroi.astype(np.int32))).to(device),
            torch.from_numpy(np.ascontiguousarray(reg_roi.astype(np.int32))).to(device),
        )

    def crop(self, src, transposed: bool):
        """(rgb (h0, w0, 3) u8, mask (h0, w0) bool) for one region, in the
        canonical (portrait) orientation."""
        k, top, left, h0, w0, rid, kind = src
        rgb = self.img[k, top : top + h0, left : left + w0]
        mask = self.reg[kind][k, top : top + h0, left : left + w0] == rid
        if transposed:
            rgb, mask = rgb.transpose(0, 1), mask.transpose(0, 1)
        return rgb, mask


def _pow2_bucket(n: int, minimum: int = 64) -> int:
    """Split-score bucket dim: tiers (256, 512, 768, 1024), then multiples of 64."""
    for tier in (256, 512, 768, 1024):
        if n <= tier:
            return tier
    return -(-n // 64) * 64


# XLA's CPU client sums the split score's float32 reductions in an order of
# its own, read from its dumps (`XLA_FLAGS=--xla_dump_to=DIR`, the optimized
# HLO and the LLVM IR of each fusion) and held bit for bit by the tests: the
# tree reduction's windows and LLVM's lanes over their grid, as
# `ops/xla_order.py sum_rows` models them for every sum over a map; a
# histogram's entropy adds its bins into 8 lanes (bin b into lane b % 8) by
# fused multiply-adds, combined in halves.  Constants are XLA's folded ones
# (a division by a constant is a product with its reciprocal; `(x / 3) *
# 0.7` is one product), and every product that feeds one addition is fused
# into it, as LLVM emits them.


_C_COLOR = prng._hex32("0x1.dddddep-3")  # 0.7 / 3
_C_GRAD = prng._hex32("0x1.99999cp-4")  # 0.3 / 3
_C_L = prng._hex32("0x1.47ae14p-7")  # 1 / 100
_C_THIRD = prng._hex32("-0x1.555556p-2")  # -1 / 3 (the entropy's sign folded in)
_C_FIFTH = prng._hex32("-0x1.99999ap-3")  # -1 / 5
_C_04 = prng._hex32("0x1.99999ap-2")
_C_06 = prng._hex32("0x1.333334p-1")
_INV_LN2 = prng._hex32("0x1.715476p+0")


def _xla_entropy_sum(h: torch.Tensor, logh: torch.Tensor) -> torch.Tensor:
    """(N, bins) -> (N,): sum of h * log2 over bins in XLA's lane order."""
    lanes = []
    for j in range(8):
        acc = torch.zeros(h.shape[0], dtype=torch.float32, device=h.device)
        for b in range(j, h.shape[1], 8):
            acc = COL.fma32(h[:, b], logh[:, b], acc)
        lanes.append(acc)
    return XO.halves(lanes)


def _split_score_batch(rgb: torch.Tensor, mask: torch.Tensor):
    """Split score of each row of a (B, H, W, 3) uint8 / (B, H, W) bool
    bucket: (overall, color, texture, count), each (B,) float32, bit for bit
    the JAX package's jitted score on the CPU (the reduction orders above)."""
    b = rgb.shape[0]
    maskf = mask.float()
    count = maskf.sum(dim=(1, 2))  # integers: exact in any order
    safe = torch.clamp(count, min=1.0)

    gray = COL.rgb_to_gray_skimage(rgb)
    lab = COL.rgb_to_lab(rgb)
    # Reference quirk (split_score.py:48-51): grad_x and grad_y are BOTH the
    # sobel magnitude, so the "gradient magnitude" is sqrt(2)*|sobel| summed
    # over the three LAB channels (XLA computes s*s once and doubles it).
    gm = None
    for ch in range(3):
        s = CONV.sobel_skimage(lab[..., ch])
        ss = s * s
        term = COL.sqrt32(ss + ss)
        gm = term if gm is None else gm + term
    grad = CONV.sobel_skimage(gray)
    chans = [lab[..., 0], lab[..., 0] * lab[..., 0], lab[..., 1], lab[..., 1] * lab[..., 1],
             lab[..., 2], lab[..., 2] * lab[..., 2], gm, grad, grad * grad, gray, gray * gray]
    sums = XO.sum_rows((torch.stack(chans, dim=1) * maskf[:, None]).reshape(b * len(chans), *gray.shape[1:]))
    means = (sums.reshape(b, len(chans)) / safe[:, None]).unbind(1)

    def std(mu, sq):
        return COL.sqrt32(torch.clamp(COL.fma32(-mu, mu, sq), min=0.0))

    l_std, a_std, b_std = std(means[0], means[1]), std(means[2], means[3]), std(means[4], means[5])
    color_variance = COL.fma32(l_std, _C_L, a_std * 0.0078125) + b_std * 0.0078125
    color_score = torch.clamp(COL.fma32(means[6], _C_GRAD, color_variance * _C_COLOR), 0.0, 1.0)
    color_in_overall = torch.clamp(COL.fma32(color_variance, _C_COLOR, means[6] * _C_GRAD), 0.0, 1.0)

    def entropy(hist):
        return _xla_entropy_sum(hist, prng.log32(hist + 1e-8) * _INV_LN2)

    lbp_codes = LBP.local_binary_pattern_uniform(gray).float()
    lbp_hist = LBP.masked_histogram_density(lbp_codes, mask, 0.0, 10.0, 10)
    lbp_score = torch.clamp(entropy(lbp_hist) * _C_THIRD, 0.0, 1.0)
    grad_score = torch.clamp(COL.fma32(-means[7], means[7], means[8]) * 50.0, 0.0, 1.0)
    int_hist = LBP.masked_histogram_density(gray, mask, 0.0, 1.0, 32)
    entropy_score = torch.clamp(entropy(int_hist) * _C_FIFTH, 0.0, 1.0)
    std_score = torch.clamp(std(means[9], means[10]) * 2.0, 0.0, 1.0)

    texture_score = torch.clamp(
        (((lbp_score + grad_score) + entropy_score) + std_score) * 0.25, 0.0, 1.0
    )
    overall = COL.fma32(color_in_overall, _C_04, texture_score * _C_06)
    return overall, color_score, texture_score, count


def _bucket_rows(rows, ph, pw, device):
    """Stack (rgb, mask) crops into one zero-padded (B, ph, pw) bucket."""
    b = len(rows)
    rgb_b = torch.zeros((b, ph, pw, 3), dtype=torch.uint8, device=device)
    mask_b = torch.zeros((b, ph, pw), dtype=torch.bool, device=device)
    for r, (rgb, mask) in enumerate(rows):
        h, w = mask.shape
        rgb_b[r, :h, :w] = torch.as_tensor(rgb, device=device)
        mask_b[r, :h, :w] = torch.as_tensor(mask, device=device)
    return rgb_b, mask_b


def split_scores_many(
    crops: list, masks: list, device, sources: list | None = None,
    dbatch: DeviceBatch | None = None, mesh=None,
) -> list:
    """Split scores, one batched device call per shape bucket.

    Rows whose `sources` entry is set slice their crop from `dbatch`.  With
    `mesh`, a bucket's rows (padded to a multiple of its data axis) split
    over its data devices.  Returns a list of (overall, color, texture);
    regions under 100 px score 0.
    """
    n = len(crops)
    out: list = [None] * n
    if sources is None:
        sources = [None] * n
    # Orientation canonicalization (exact: every statistic is transpose-
    # invariant) halves the number of buckets.
    buckets: dict = {}
    for i in range(n):
        m = masks[i]
        transposed = m.shape[1] > m.shape[0]
        h, w = (m.shape[1], m.shape[0]) if transposed else m.shape
        buckets.setdefault((_pow2_bucket(h), _pow2_bucket(w)), []).append((i, transposed))
    with stage_timer("seg.score"):
        for (ph, pw), items in buckets.items():
            rows = []
            for i, transposed in items:
                if sources[i] is not None and dbatch is not None:
                    rows.append(dbatch.crop(sources[i], transposed))
                else:
                    c, m = crops[i], masks[i]
                    if transposed:
                        c, m = np.transpose(c, (1, 0, 2)), m.T
                    rows.append((np.ascontiguousarray(c), np.ascontiguousarray(m)))
            rgb_b, mask_b = _bucket_rows(rows, ph, pw, device)
            bp = SHARD.pad_rows(len(rows), mesh)
            scores = DISPATCH.call(
                _split_score_batch,
                SHARD.shard_rows(SHARD.pad_to(rgb_b, bp), mesh),
                SHARD.shard_rows(SHARD.pad_to(mask_b, bp), mesh),
            )
            overall, color, texture, count = SHARD.collect_all(scores)
            for row, (i, _) in enumerate(items):
                if count[row] < 100:
                    out[i] = (0.0, 0.0, 0.0)
                else:
                    out[i] = (float(overall[row]), float(color[row]), float(texture[row]))
    return out


def split_score(bbox_rgb: np.ndarray, bbox_mask: np.ndarray, device):
    """(overall, color, texture) of one region crop; regions under 100 px
    score 0."""
    return split_scores_many([bbox_rgb], [bbox_mask], device)[0]


def optimal_segments_many(
    crops: list, masks: list, device, sources: list | None = None,
    dbatch: DeviceBatch | None = None, mesh=None,
) -> list:
    """Split score -> SLIC segment counts via the logistic window law."""
    scores = split_scores_many(crops, masks, device, sources=sources, dbatch=dbatch, mesh=mesh)
    return [
        cfg.logistic_segments(scores[i][0], cfg.segment_window(crops[i].size))
        for i in range(len(crops))
    ]


def optimal_segments(bbox_rgb: np.ndarray, bbox_mask: np.ndarray, device) -> int:
    """SLIC segment count of one region crop (the logistic window law of its
    split score)."""
    return optimal_segments_many([bbox_rgb], [bbox_mask], device)[0]


# ---------------------------------------------------------------------------
# PIL's antialiased bilinear resample, in numpy (the card's machine has no
# PIL).  Same fixed-point arithmetic as libImaging/Resample.c: double
# coefficients normalised per output pixel, rounded to 22-bit integers,
# horizontal pass first into uint8, then vertical.
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _resample_coeffs(in_size: int, out_size: int):
    """(bounds (out, 2) int64 [xmin, count], kk (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # bilinear filter support
    ksize = int(math.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.float64)
    bounds = np.zeros((out_size, 2), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        wv = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        ww = 0.0
        for v in wv:  # sequential sum, as the C loop
            ww += v
        if ww != 0.0:
            wv = wv / ww
        kk[xx, :xmax] = wv
        bounds[xx] = (xmin, xmax)
    scaled = kk * (1 << _PRECISION_BITS)
    kint = np.where(scaled < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5)).astype(np.int64)
    return bounds, kint


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resample pass along `axis` of an (h, w, c) uint8 array."""
    in_size = img.shape[axis]
    bounds, kint = _resample_coeffs(in_size, out_size)
    ksize = kint.shape[1]
    idx = np.minimum(bounds[:, :1] + np.arange(ksize)[None, :], in_size - 1)
    x = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, c)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(ksize):
        acc += x[idx[:, t]] * kint[:, t].reshape((-1,) + (1,) * (x.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize_uint8(img: np.ndarray, shape: tuple) -> np.ndarray:
    """Antialiased bilinear downscale, bit-identical to
    PIL.Image.resize((w, h), Image.BILINEAR) on an RGB uint8 image."""
    out = np.asarray(img, np.uint8)
    if out.shape[1] != shape[1]:
        out = _resample_axis(out, shape[1], 1)
    if out.shape[0] != shape[0]:
        out = _resample_axis(out, shape[0], 0)
    return np.ascontiguousarray(out)


def _resize_nearest(arr: np.ndarray, shape: tuple) -> np.ndarray:
    """Nearest-neighbor resize via index maps (half-pixel centers)."""
    h, w = arr.shape[:2]
    nh, nw = shape
    rows = np.minimum(((np.arange(nh) + 0.5) * h / nh).astype(np.int64), h - 1)
    cols = np.minimum(((np.arange(nw) + 0.5) * w / nw).astype(np.int64), w - 1)
    return arr[rows][:, cols]


def region_segments_many(
    crops: list,
    masks: list,
    n_segments: list,
    device,
    compactness: float = 10.0,
    sigma: float = 1.0,
    sources: list | None = None,
    dbatch: DeviceBatch | None = None,
    mesh=None,
) -> list:
    """Batched SLIC at <= 500 px working resolution, labels upsampled back.

    Returns a list of (bh_i, bw_i) int32 label maps, 0 outside mask.
    """
    n = len(crops)
    if sources is None:
        sources = [None] * n
    work_imgs: list = [None] * n
    work_masks: list = [None] * n
    work_n: list = [0] * n
    work_src: list = [None] * n
    scaled = [False] * n
    out: list = [None] * n
    run_ids = []
    for i in range(n):
        h, w = masks[i].shape
        scale = cfg.slic_scale_factor(max(crops[i].shape))
        if scale < 1.0:
            nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
            small_mask = _resize_nearest(masks[i], (nh, nw))
            if not small_mask.any():
                out[i] = np.zeros((h, w), np.int32)
                continue
            work_imgs[i] = _resize_uint8(crops[i], (nh, nw))
            work_masks[i] = small_mask
            work_n[i] = max(1, math.ceil(n_segments[i] * scale * scale))
            scaled[i] = True
        else:
            # Unscaled rows slice their crop from the device batch; resized
            # rows exist only on the host.
            work_imgs[i] = crops[i]
            work_masks[i] = masks[i]
            work_n[i] = n_segments[i]
            work_src[i] = sources[i]
        run_ids.append(i)

    with stage_timer("seg.slic"):
        labels_small = SLIC.slic_many(
            [work_imgs[i] for i in run_ids],
            [work_masks[i] for i in run_ids],
            [work_n[i] for i in run_ids],
            device,
            compactness=compactness,
            sigma=sigma,
            sources=[work_src[i] for i in run_ids],
            dbatch=dbatch,
            mesh=mesh,
        )
    for pos, i in enumerate(run_ids):
        lab = labels_small[pos]
        if scaled[i]:
            lab = _resize_nearest(lab, masks[i].shape).astype(np.int32)
            # Upsampled labels can leak outside the full-res mask; clamp.
            lab[~masks[i]] = 0
        out[i] = lab
    return out


def region_segments(bbox_rgb: np.ndarray, bbox_mask: np.ndarray, n_segments: int, device,
                    compactness: float = 10.0, sigma: float = 1.0) -> np.ndarray:
    """SLIC labels of one region crop (see region_segments_many)."""
    return region_segments_many(
        [bbox_rgb], [bbox_mask], [n_segments], device, compactness=compactness, sigma=sigma,
    )[0]
