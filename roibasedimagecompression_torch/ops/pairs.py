"""Device-resident (segment, color) pair table.

The tier-1 pair table of a whole batch, built on the device the segment stage
already holds the pixels on (the counterpart of the JAX package's
`ops/pairs.py`):

  1. one stable sort of the per-pixel key `segment << 24 | packed color`, with
     segment 0 (background) mapped to a sentinel that sorts last,
  2. unique flags and cumulative pair ids over the sorted keys,
  3. scatter-compaction of the unique table and the per-pair pixel counts.

The host downloads only the compacted table.  The per-pixel pair ids and the
sort permutation stay on the device, so the final palette-index paint is one
gather and one scatter there, and the download is the per-pixel index map
itself (`models/codec.tiers23_palette_indices`).

Everything here is integer arithmetic: the tables, the painted map and the
refit sums equal the host runtime's `pack_pairs` path exactly, on the CPU and
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.utils import flops as FLOPS
from roibasedimagecompression_torch.utils.timing import stage_timer

_SENTINEL = torch.iinfo(torch.int64).max


def _pow2(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _pair_sort(seg_flat: torch.Tensor, rgb_flat: torch.Tensor):
    """Sort the pixels by (segment, packed color); segment 0 sorts last.

    seg_flat (n,) integer, rgb_flat (n, 3) uint8.  Returns (key_s, perm, new,
    pair_id, n_pairs, n_valid): the sorted int64 keys `seg << 24 | col`
    (sentinel for background), the sort's indices, the flags of each pair's
    first pixel, the pair row of every sorted pixel, and the counts of pairs
    and of segment pixels as Python ints.  The valid pixels are exactly the
    first n_valid sorted ones.
    """
    rgb = rgb_flat.long()
    col = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    seg = seg_flat.long()
    key = torch.where(seg > 0, (seg << 24) | col, torch.full_like(seg, _SENTINEL))
    key_s, perm = torch.sort(key, stable=True)
    valid = key_s != _SENTINEL
    new = valid.clone()
    new[1:] &= key_s[1:] != key_s[:-1]
    pair_id = torch.cumsum(new, dim=0) - 1
    n_pairs, n_valid = torch.stack([new.sum(), valid.sum()]).tolist()
    return key_s, perm, new, pair_id, int(n_pairs), int(n_valid)


def _post_repair_colors(out_seg, out_col, n_pairs: int, cap: int) -> torch.Tensor:
    """Post-black-repair colors table (cap, 3) uint8 from the compacted pairs.

    `native.black_repair_pairs` drops row i exactly when it is a black pair
    (col == 0, always its segment's first row: the sort key is ascending) in
    a segment with at least one non-black color, then compacts the kept rows
    in order.  The same predicate and a cumulative-sum compaction reproduce
    the host colors table, so the split stage's colors never cross to the
    device again.
    """
    rows = torch.arange(cap, device=out_seg.device)
    valid_row = rows < n_pairs
    seg_next = torch.roll(out_seg, -1)
    drop = valid_row & (out_col == 0) & (rows + 1 < n_pairs) & (seg_next == out_seg)
    keep = valid_row & ~drop
    newpos = torch.cumsum(keep, dim=0) - 1
    cidx = torch.where(keep, newpos, torch.full_like(newpos, cap))
    rgb = torch.stack(
        [(out_col >> 16) & 0xFF, (out_col >> 8) & 0xFF, out_col & 0xFF], dim=1
    ).to(torch.uint8)
    out = torch.zeros((cap + 1, 3), dtype=torch.uint8, device=out_seg.device)
    out[cidx] = rgb  # dropped rows land in the extra row
    return out[:cap]


def _compact_rows(key_s, new, pair_id, n_valid: int, cap: int):
    """(out_seg, out_col, counts), each (cap,) int32: the flagged rows
    scattered to their pair ids, every other row into one extra slot that is
    sliced off.  counts[j] = start[j + 1] - start[j] over the sorted run
    starts, the tail closed by n_valid."""
    dev = key_s.device
    idx = torch.where(new, pair_id, torch.full_like(pair_id, cap))
    seg_s = (key_s >> 24).int()
    col_s = (key_s & 0xFFFFFF).int()
    out_seg = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    out_seg[idx] = seg_s
    out_col = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    out_col[idx] = col_s
    # The starts table has cap + 1 entries, so its drop target is cap + 1:
    # index cap is valid here, and a drop target of cap would corrupt the last
    # count exactly when n_pairs == cap.
    idx_starts = torch.where(new, pair_id, torch.full_like(pair_id, cap + 1))
    starts = torch.full((cap + 2,), n_valid, dtype=torch.int32, device=dev)
    starts[idx_starts] = torch.arange(len(key_s), dtype=torch.int32, device=dev)
    counts = torch.diff(starts[: cap + 1])
    return out_seg[:cap], out_col[:cap], counts


def _pair_compact(key_s, new, pair_id, n_valid: int, n_pairs: int, *, cap: int):
    """((cap, 3) int32 [seg, col, count] table, (cap, 3) uint8 post-repair
    colors), both on the device.

    The JAX package also has a two-word form of the table for its download
    (`_pair_compact_packed`).  On an NVIDIA H100 80GB HBM3 at 700 W it saves
    0.46 ms of 3.98 (compact, read-back and unpack of 687,183 pairs;
    `scripts/port_stream_probe.py pairs`) in a batch of seconds, so the port
    keeps this form only."""
    out_seg, out_col, counts = _compact_rows(key_s, new, pair_id, n_valid, cap)
    return (
        torch.stack([out_seg, out_col, counts], dim=1),
        _post_repair_colors(out_seg, out_col, n_pairs, cap),
    )


def _paint_indices(perm, pair_id, n_valid: int, idx_of_pair, dtype) -> torch.Tensor:
    """Final palette-index paint: one gather and one scatter.  The indices of
    `perm` are unique, so the scatter is deterministic."""
    out = torch.zeros(perm.shape[0], dtype=dtype, device=perm.device)
    out[perm[:n_valid]] = idx_of_pair[pair_id[:n_valid]].to(dtype)
    return out


def _refit_sums(perm, pair_id, key_s, n_valid: int, idx_of_pair,
                *, k_pad: int, hw: int, b: int) -> torch.Tensor:
    """Per-(image, palette index) pixel counts and exact RGB sums: (b * k_pad,
    4) int32 [count, sum_r, sum_g, sum_b].

    The zero-rate palette refit (`models/refine.refit_pixels`) is a bincount
    of the original pixels at fixed final indices, and every input is on the
    device already.  int32 accumulation is exact and order-free (per-bin
    channel sums <= 255 * hw < 2^31, which the caller enforces), hence equal
    to the host's float64 bincount.  Segment pixels are enough: background
    pixels only map to palette index 0 when the palette's first entry is
    black, which refit freezes.
    """
    col_s = key_s[:n_valid] & 0xFFFFFF
    idx = idx_of_pair[pair_id[:n_valid]].long()
    bins = (perm[:n_valid] // hw) * k_pad + idx
    data = torch.stack(
        [torch.ones_like(col_s), (col_s >> 16) & 0xFF, (col_s >> 8) & 0xFF, col_s & 0xFF],
        dim=1,
    ).int()
    out = torch.zeros((b * k_pad, 4), dtype=torch.int32, device=perm.device)
    return out.index_add_(0, bins, data)


class DevicePairTable:
    """Pair table built on the device; per-pixel state stays there.

    Equals `native.pack_pairs` exactly: `uniq` is the sorted
    (seg << 24 | packed_color) int64 table, `counts` the per-pair pixel
    multiplicities, `n_pairs` their number, and `colors_dev` the (cap, 3)
    uint8 post-black-repair colors on the device (None without pairs).
    `paint(idx_of_pair)` replaces the host `paint_masked_indices` pass.

    tall_seg is the (b * h, w) segment map of the stacked batch.  The pixels
    come from `images_dev`, the segment stage's (b, h, w, 3) uint8 tensor, or
    are uploaded from `tall_img` to `device`.
    """

    def __init__(self, tall_seg: np.ndarray, images_dev: torch.Tensor | None = None,
                 tall_img: np.ndarray | None = None, device=None):
        self.n_pix = tall_seg.size
        if images_dev is None:
            images_dev = torch.from_numpy(np.ascontiguousarray(tall_img, np.uint8)).to(device)
        rgb_flat = images_dev.reshape(-1, 3)
        if rgb_flat.shape[0] != self.n_pix:
            raise ValueError("the segment map and the images disagree on the pixel count")
        seg_flat = torch.from_numpy(
            np.ascontiguousarray(tall_seg, np.int32).reshape(-1)
        ).to(rgb_flat.device)
        with stage_timer("pairs.sort"):
            (self._key_s, self._perm, new, self._pair_id,
             self.n_pairs, self._n_valid) = FLOPS.track(_pair_sort, (seg_flat, rgb_flat), {})
        self.colors_dev = None
        if self.n_pairs <= 0:
            self.uniq = np.zeros(0, np.int64)
            self.counts = np.zeros(0, np.int64)
            return
        cap = _pow2(self.n_pairs, minimum=4096)
        with stage_timer("pairs.compact"):
            table, self.colors_dev = FLOPS.track(
                _pair_compact, (self._key_s, new, self._pair_id, self._n_valid, self.n_pairs),
                {"cap": cap},
            )
            self.uniq, self.counts = native.unpack_pair_table(
                table[: self.n_pairs].cpu().numpy()
            )

    def paint(self, idx_of_pair: np.ndarray, repair_remap=None,
              refit_bins: tuple | None = None):
        """(n_pix,) final palette indices (uint8 when every index fits, else
        uint16 or uint32).

        idx_of_pair indexes the post-repair pair table; repair_remap (from
        the black repair) lifts it back to this table's pre-repair rows.

        refit_bins: optional (b, hw, k_pad): also accumulate the refit table
        (`_refit_sums`) and return (indices, (b * k_pad, 4) int32 [count,
        sum_r, sum_g, sum_b]).
        """
        if repair_remap is not None:
            idx_of_pair = idx_of_pair[repair_remap]
        mx = int(idx_of_pair.max()) if idx_of_pair.size else 0
        host_dtype = np.uint8 if mx < 256 else (np.uint16 if mx < 65536 else np.uint32)
        dev = self._perm.device
        idx_dev = torch.from_numpy(np.ascontiguousarray(idx_of_pair, np.int32)).to(dev)
        with stage_timer("pairs.paint"):
            out = FLOPS.track(_paint_indices, (
                self._perm, self._pair_id, self._n_valid, idx_dev,
                torch.uint8 if mx < 256 else torch.int32,
            ), {})
            host = out.cpu().numpy().astype(host_dtype, copy=False)
        if refit_bins is None:
            return host
        b, hw, k_pad = refit_bins
        with stage_timer("pairs.refit"):
            sums = FLOPS.track(
                _refit_sums, (self._perm, self._pair_id, self._key_s, self._n_valid, idx_dev),
                {"k_pad": k_pad, "hw": hw, "b": b},
            ).cpu().numpy()
        return host, sums
