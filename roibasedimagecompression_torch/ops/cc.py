"""Connected components of a boolean mask and per-component statistics.

The counterpart of the JAX package's `ops/cc.py`.  With the native runtime,
components are its union-find (`native.cc_label`) and the statistics its one
pass.  Without it (RHCCQ_NATIVE=0) they are the JAX package's device
fallback: iterative min-label propagation on the caller's device (a
neighbour-min stencil, root hooking and pointer jumping, repeated to the
fixpoint), and numpy statistics.

Every propagation here converges to the least initial value of each
component of its graph; that fixpoint does not depend on the order of the
sweeps, so the labels equal the JAX package's on every device.  Everything
here is integer work or float64 means of the same values in the same order,
so it is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.utils import device as DEV

INT_MAX = 2**31 - 1
_SHIFTS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_SHIFTS8 = _SHIFTS4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))

# Propagation passes (stencil, hook, chase) run since the last reset; read
# by the chip smoke run to report passes per encode.
PASSES = [0]


def shifted(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """x[..., i + dr, j + dc], `fill` beyond the border ((..., h, w))."""
    h, w = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]


def _propagate_min(init: torch.Tensor, fg: torch.Tensor, gates: dict, connectivity: int) -> torch.Tensor:
    """Min-label propagation over (..., h, w) int64 labels to the fixpoint;
    background holds INT_MAX, `gates[(dr, dc)]` masks a neighbour edge.

    Every label is the flat index of a pixel of its own component, so each
    pass takes the neighbours' minimum, hooks each old root (the pixel a
    label names) onto the least label that reached one of its members, and
    chases every label to its root (lab <- lab[lab]).  The JAX package
    sweeps stencils and run-wise scans instead; both end at each
    component's least index, so the labels are the same, in O(log n) passes
    here."""
    shifts = _SHIFTS4 if connectivity == 4 else _SHIFTS8
    big = torch.tensor(INT_MAX, dtype=torch.int64, device=init.device)
    h, w = init.shape[-2:]
    flat_fg = fg.reshape(-1, h * w)
    lab = init
    while True:
        PASSES[0] += 1
        new = lab
        for dr, dc in shifts:
            nb = shifted(lab, dr, dc, INT_MAX)
            gate = gates.get((dr, dc))
            if gate is not None:
                nb = torch.where(gate, nb, big)
            new = torch.minimum(new, nb)
        cur = torch.where(fg, new, big).reshape(-1, h * w)
        old = lab.reshape(-1, h * w)
        root = torch.where(flat_fg, old, 0)
        cur = cur.scatter_reduce(1, root, torch.where(flat_fg, cur, big), reduce="amin")
        while True:
            hop = torch.minimum(cur, torch.gather(cur, 1, torch.where(flat_fg, cur, 0)))
            hop = torch.where(flat_fg, hop, big)
            if torch.equal(hop, cur):
                break
            cur = hop
        if torch.equal(cur, old):
            return lab
        lab = cur.reshape(lab.shape)


def _flat_ids(shape, device) -> torch.Tensor:
    h, w = shape[-2:]
    return torch.arange(h * w, dtype=torch.int64, device=device).reshape(h, w)


def propagate_labels(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Min-index labels of the components of (..., h, w) bool masks: each
    component carries the least flat index of its pixels; background gets
    INT_MAX.  int64."""
    fg = mask.bool()
    init = torch.where(fg, _flat_ids(fg.shape, fg.device), INT_MAX)
    return _propagate_min(init, fg, {}, connectivity)


def propagate_keys(keys: torch.Tensor, mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """The least int32 key of each component reaches all its members;
    background gets INT_MAX.  The JAX package propagates the keys
    themselves; the fixpoint is the same as labelling the components (with
    pointer jumping, far fewer passes) and taking each one's least key."""
    fg = mask.bool()
    h, w = fg.shape[-2:]
    labels = propagate_labels(fg, connectivity).reshape(-1, h * w)
    k = torch.where(fg, keys.to(torch.int64), INT_MAX).reshape(-1, h * w)
    seg = torch.where(labels < INT_MAX, labels, 0)
    least = torch.full_like(k, INT_MAX).scatter_reduce(1, seg, k, reduce="amin")
    out = torch.where(labels < INT_MAX, torch.gather(least, 1, seg), INT_MAX)
    return out.reshape(fg.shape)


def propagate_equal_labels(values: torch.Tensor, mask: torch.Tensor,
                           connectivity: int = 4) -> torch.Tensor:
    """Min-index labels of the components whose neighbours share `values`
    (a segmentation map's connected fragments); background gets INT_MAX."""
    fg = mask.bool()
    init = torch.where(fg, _flat_ids(fg.shape, fg.device), INT_MAX)
    vals = torch.where(fg, values.to(torch.int64), -1)
    shifts = _SHIFTS4 if connectivity == 4 else _SHIFTS8
    gates = {s: shifted(vals, s[0], s[1], -2) == vals for s in shifts}
    return _propagate_min(init, fg, gates, connectivity)


def adopt_labels(labels: torch.Tensor, keep: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Every unkept mask pixel of (..., h, w) maps takes the label of its
    nearest kept pixel, by the JAX package's jump flood: the same step
    schedule, neighbour order and strict `cand < best`.  Squared distances
    to real seeds are integers below 2^24, exact in float32."""
    h, w = labels.shape[-2:]
    dev = labels.device
    fg = mask.bool()
    seeds = keep.bool() & fg
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = 1 << 20
    sy = torch.where(seeds, yy, big)
    sx = torch.where(seeds, xx, big)
    lab = labels.to(torch.int64)
    sl = torch.where(seeds, lab, INT_MAX)

    def d2(a, b):
        dy = (a - yy).float()
        dx = (b - xx).float()
        return dy * dy + dx * dx

    max_step, n_steps = 1, 1
    while max_step < max(h, w):
        max_step *= 2
        n_steps += 1
    pad = max_step
    for i in range(n_steps):
        k = max_step >> i
        py = torch.nn.functional.pad(sy, (pad, pad, pad, pad), value=big)
        px = torch.nn.functional.pad(sx, (pad, pad, pad, pad), value=big)
        pl = torch.nn.functional.pad(sl, (pad, pad, pad, pad), value=INT_MAX)
        best = d2(sy, sx)
        for dr_s, dc_s in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)):
            r0, c0 = pad + k * dr_s, pad + k * dc_s
            cy = py[..., r0 : r0 + h, c0 : c0 + w]
            cx = px[..., r0 : r0 + h, c0 : c0 + w]
            cl = pl[..., r0 : r0 + h, c0 : c0 + w]
            cand = d2(cy, cx)
            better = cand < best
            sy = torch.where(better, cy, sy)
            sx = torch.where(better, cx, sx)
            sl = torch.where(better, cl, sl)
            best = torch.where(better, cand, best)
    # Kept pixels keep their own label; unreachable pixels fall back too.
    return torch.where(seeds | (sl == INT_MAX), torch.where(fg, lab, sl), sl)


def connected_components(mask: np.ndarray, connectivity: int = 8, device=None):
    """cv2.connectedComponents analogue: (labels (h, w) int32 with 0 the
    background and 1..n compact ids in raster order, n + 1).  The runtime's
    union-find, or without it the min-label propagation on `device` (the
    CPU when None) compacted by np.unique: the same ids either way."""
    mask = np.asarray(mask) != 0
    if not mask.any():
        return np.zeros(mask.shape, np.int32), 1
    out = native.cc_label(mask, connectivity)
    if out is not None:
        labels, n, _ = out
        return labels, n + 1
    raw = propagate_labels(torch.from_numpy(mask).to(DEV.or_cpu(device)), connectivity).cpu().numpy()
    uniq, inv = np.unique(raw[mask], return_inverse=True)
    labels = np.zeros(mask.shape, np.int32)
    labels[mask] = inv.astype(np.int32) + 1
    return labels, len(uniq) + 1


@dataclasses.dataclass
class ComponentStats:
    """Per-component stats, indexed by compact label (0 = background row)."""

    areas: np.ndarray  # (num,) int64
    bboxes: np.ndarray  # (num, 4) int32 (minr, minc, maxr, maxc), exclusive max

    def width(self):
        return self.bboxes[:, 3] - self.bboxes[:, 1]

    def height(self):
        return self.bboxes[:, 2] - self.bboxes[:, 0]


def component_stats(labels: np.ndarray, num_labels: int) -> ComponentStats:
    """Areas and bounding boxes per label (the runtime's one pass, else
    numpy's bincount and extrema)."""
    out = native.component_stats(labels, num_labels)
    if out is not None:
        return ComponentStats(areas=out[0], bboxes=out[1])
    flat = labels.ravel()
    areas = np.bincount(flat, minlength=num_labels)
    h, w = labels.shape
    rows = np.repeat(np.arange(h), w)
    cols = np.tile(np.arange(w), h)
    minr = np.full(num_labels, h, np.int64)
    maxr = np.zeros(num_labels, np.int64)
    minc = np.full(num_labels, w, np.int64)
    maxc = np.zeros(num_labels, np.int64)
    np.minimum.at(minr, flat, rows)
    np.maximum.at(maxr, flat, rows)
    np.minimum.at(minc, flat, cols)
    np.maximum.at(maxc, flat, cols)
    bboxes = np.stack([minr, minc, maxr + 1, maxc + 1], axis=1).astype(np.int32)
    bboxes[areas == 0] = 0
    return ComponentStats(areas=areas, bboxes=bboxes)


def label_means(labels: np.ndarray, values: np.ndarray, num_labels: int) -> np.ndarray:
    """float64 mean of `values` per label."""
    flat = labels.ravel()
    sums = np.bincount(flat, weights=values.ravel().astype(np.float64), minlength=num_labels)
    counts = np.bincount(flat, minlength=num_labels)
    out = np.zeros(num_labels, np.float64)
    nz = counts > 0
    out[nz] = sums[nz] / counts[nz]
    return out


def remove_labels(mask: np.ndarray, labels: np.ndarray, drop_ids: np.ndarray) -> np.ndarray:
    """A copy of `mask` with the pixels of the given label ids zeroed."""
    out = mask.copy()
    if len(drop_ids):
        out[np.isin(labels, drop_ids)] = 0
    return out
