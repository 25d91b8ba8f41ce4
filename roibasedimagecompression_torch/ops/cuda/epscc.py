"""eps-graph connected components (DBSCAN, min_samples=1) over palette rows.

`eps_sweep` is one masked-min label sweep (kernel `csrc/epscc.cu`, the
counterpart of the JAX package's Pallas `eps_sweep_pallas`); on a CPU tensor
it runs the plain version `eps_sweep_ref`.  `eps_components_rows` is the
counterpart of the driver `eps_components_pallas`.  On a CUDA tensor the whole
loop (sweeps, root chasing, the test for convergence) is one cooperative
kernel: the host packs, launches once and reads the result.  On a CPU tensor,
or with `sweep=eps_sweep_ref`, it runs the plain form of the same loop.

Both loops lower labels monotonically to indices of the same component and
stop after a round without a change, which is a fixed point of every edge: the
labels are each component's least point index whatever the order of updates,
so the count of sweeps may differ between the two and the labels may not.
"""

from __future__ import annotations

import torch

from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS
from roibasedimagecompression_torch.utils import timing

INT_MAX = 2**31 - 1


def eps_sweep_ref(points, labels, valid, groups, eps2) -> torch.Tensor:
    """Plain version of one sweep: (B, N) int32 proposed labels."""
    b, n, _ = points.shape
    out = torch.empty((b, n), dtype=torch.int32, device=points.device)
    gcol = torch.where(valid.bool(), groups, torch.full_like(groups, -1))
    chunk = max(1, (1 << 24) // max(1, b * n))
    for s in range(0, n, chunk):
        rows = points[:, s : s + chunk]
        d2 = torch.zeros((b, rows.shape[1], n), dtype=torch.float32, device=points.device)
        for c in range(3):
            diff = rows[..., c, None] - points[:, None, :, c]
            d2 = d2 + diff * diff
        gi = groups[:, s : s + chunk, None]
        adj = (d2 <= eps2[:, None, None]) & (gcol[:, None, :] == gi) & (gi >= 0)
        lab = torch.where(adj, labels[:, None, :], torch.full_like(labels[:, None, :], INT_MAX))
        out[:, s : s + chunk] = lab.min(dim=2).values
    return out


def packed_adjacency(packed_i: torch.Tensor, packed_j: torch.Tensor, eps2: torch.Tensor) -> torch.Tensor:
    """The kernel's distance predicate in plain integer arithmetic: byte-wise
    absolute difference of two packed colours (r | g << 8 | b << 16), its dot
    product with itself, and `<= floor(eps2)`; eps2 float32, >= 0."""
    d2 = torch.zeros((), dtype=torch.int64, device=packed_i.device)
    for shift in (0, 8, 16):
        diff = ((packed_i >> shift) & 0xFF).long() - ((packed_j >> shift) & 0xFF).long()
        d2 = d2 + diff.abs() * diff.abs()
    return d2 <= torch.floor(eps2).long()


def _pack(dev, b, n, points, rows, valid, groups, eps2, fill_labels: bool):
    """Launch the pack kernel; (packed, gcol, fill, meta) on the card.  Not
    recorded in `_build.launched`: it precedes every sweep and loop launch."""
    packed, gcol, fill = torch.empty((3, b, n), dtype=torch.int32, device=dev)
    meta = torch.empty(4 * b + 4, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch("epscc", "eps_pack_launch", dev, ptr(points), ptr(rows), ptr(valid), ptr(groups),
                  eps2.data_ptr(), packed.data_ptr(), gcol.data_ptr(), fill.data_ptr(),
                  int(fill_labels), meta.data_ptr(), b, n)
    return packed, gcol, fill, meta


def eps_sweep(points, labels, valid, groups, eps2) -> torch.Tensor:
    """One sweep: points (B, N, 3) f32 holding integers in [0, 255], labels and
    groups (B, N) int32, valid (B, N) uint8, eps2 (B,) f32 -> (B, N) int32
    (INT_MAX where no neighbor)."""
    b, n = labels.shape
    if points.shape != (b, n, 3) or valid.shape != (b, n) or groups.shape != (b, n) or eps2.shape != (b,):
        raise ValueError("eps_sweep: inconsistent shapes")
    if (points.dtype, labels.dtype, valid.dtype, groups.dtype, eps2.dtype) != (
        torch.float32, torch.int32, torch.uint8, torch.int32, torch.float32
    ):
        raise ValueError("eps_sweep: expected f32 points/eps2, int32 labels/groups, uint8 valid")
    dev = points.device
    if any(t.device != dev for t in (labels, valid, groups, eps2)):
        raise ValueError("eps_sweep: tensors on different devices")
    if dev.type == "cpu":
        return eps_sweep_ref(points, labels, valid, groups, eps2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (points, labels, valid, groups, eps2)):
        raise ValueError("eps_sweep takes contiguous tensors")
    packed, gcol, out, meta = _pack(dev, b, n, points, None, valid, groups, eps2, False)
    _build.launch("epscc", "eps_sweep_launch", dev, packed.data_ptr(), groups.data_ptr(),
                  gcol.data_ptr(), labels.data_ptr(), out.data_ptr(), meta.data_ptr(), b, n,
                  key=("sweep", b, n))
    return out


def enqueue_components(b, n, dev, points, rows, valid, groups, eps2):
    """Enqueue the pack kernel and the loop kernel on the current stream and
    return (labels, meta) on the card without waiting for either: what a
    caller times by CUDA events to see the loop's device time alone.  The
    loop's launch is recorded under (B, N), the lone sweep's under ("sweep",
    B, N)."""
    packed, gcol, lab, meta = _pack(dev, b, n, points, rows, valid, groups, eps2, True)
    boxes = torch.empty((b, -(-n // 256), 2), dtype=torch.int32, device=dev)
    _build.launch("epscc", "eps_components_launch", dev, packed.data_ptr(), gcol.data_ptr(),
                  lab.data_ptr(), meta.data_ptr(), boxes.data_ptr(), b, n, key=(b, n))
    return lab, meta


def _components_cuda(b, n, dev, points, rows, valid, groups, eps2):
    """Pack, run the loop kernel, read back the round count: 2 launches and
    one device-to-host read per call.  The rounds are counted as `eps_rounds`
    (`utils/timing.py`)."""
    if b == 0 or n == 0:
        return torch.empty((b, n), dtype=torch.int32, device=dev), 0
    lab, meta = enqueue_components(b, n, dev, points, rows, valid, groups, eps2)
    meta = meta.cpu()
    if int(meta[4 * b + 2]):
        raise ValueError("eps components: colours must be integers in [0, 255]")
    sweeps = int(meta[3 : 4 * b : 4].max()) + 2
    timing.count("eps_rounds", sweeps)
    if FLOPS.enabled():
        FLOPS.add(12 * _valid_pairs(rows, valid, groups) * sweeps,
                  b * n * (4 if rows is not None else 17) + b * n * 4)
    return lab, sweeps


def _valid_pairs(rows, valid, groups) -> int:
    """Pairs of valid points in one group, summed over the rows: the pairs
    one round of the loop kernel compares (for the operation count)."""
    if rows is not None:
        n_valid = (rows >= 0).sum(dim=1).double()
        return int((n_valid * n_valid).sum())
    g = torch.where(valid.bool(), groups, torch.full_like(groups, -1)).long()
    total = 0
    for r in range(g.shape[0]):
        _, counts = torch.unique(g[r][g[r] >= 0], return_counts=True)
        total += int((counts.double() ** 2).sum())
    return total


def plain_round(points, lab, valid, groups, eps2, active, sweep=eps_sweep_ref):
    """One round of the loop on the batch rows `active` (B,) bool, in plain
    PyTorch: sweep, min-combine, hook each lowered point's old root, chase all
    labels to their roots.  Returns (labels, changed (B,) bool); rows that are
    not active come back as they were."""
    rows = torch.nonzero(active).flatten()
    new = lab.clone()
    if len(rows) == 0:
        return new, torch.zeros_like(active)
    v, old = valid[rows], lab[rows]
    n = lab.shape[1]
    proposed = sweep(points[rows].contiguous(), old.contiguous(), v.to(torch.uint8).contiguous(),
                     groups[rows].contiguous(), eps2[rows].contiguous())
    cur = torch.where(v, torch.minimum(old, proposed), old)
    root = torch.where(v, old, torch.zeros_like(old)).long()
    cur = cur.scatter_reduce(1, root, torch.where(v, cur, torch.full_like(cur, INT_MAX)), "amin")
    for _ in range(max(1, (n - 1).bit_length())):
        safe = torch.where(v, cur, torch.zeros_like(cur)).long()
        hop = torch.where(v, torch.minimum(cur, torch.gather(cur, 1, safe)), cur)
        if torch.equal(hop, cur):
            break
        cur = hop
    new[rows] = cur
    changed = torch.zeros_like(active)
    changed[rows] = (cur != old).any(dim=1)
    return new, changed


def eps_components_rows(points, valid, groups, eps2, sweep=eps_sweep):
    """Connected components of each row's eps-graph.

    points (B, N, 3) f32 holding integers in [0, 255], valid (B, N) bool,
    groups (B, N) int32 (edges join equal groups >= 0 only), eps2 (B,) f32.
    Returns ((B, N) int32 labels, sweeps): each component carries its minimum
    point index; invalid points get N; `sweeps` is the most rounds any row
    took.  `sweep` is eps_sweep or, for a plain run on any device,
    eps_sweep_ref.
    """
    b, n = valid.shape
    dev = points.device
    if sweep is eps_sweep and dev.type == "cuda":
        args = (points, valid.to(torch.uint8), groups, eps2)
        if points.shape != (b, n, 3) or groups.shape != (b, n) or eps2.shape != (b,):
            raise ValueError("eps_components_rows: inconsistent shapes")
        if (points.dtype, groups.dtype, eps2.dtype) != (torch.float32, torch.int32, torch.float32):
            raise ValueError("eps_components_rows: expected f32 points/eps2 and int32 groups")
        if any(t.device != dev or not t.is_contiguous() for t in args):
            raise ValueError("eps_components_rows takes contiguous tensors on one device")
        return _components_cuda(b, n, dev, args[0], None, *args[1:])
    groups = torch.where(valid, groups, torch.full_like(groups, -1))
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    lab = torch.where(valid, idx, torch.full_like(idx, INT_MAX)).contiguous()
    active = torch.ones(b, dtype=torch.bool, device=dev)
    sweeps = 0
    while bool(active.any()) and sweeps < n:
        lab, active = plain_round(points, lab, valid, groups, eps2, active, sweep)
        sweeps += 1
    return torch.where(lab == INT_MAX, torch.full_like(lab, n), lab), sweeps


def eps_components_packed(rows: torch.Tensor, eps2: torch.Tensor):
    """`eps_components_rows` for rows of packed colours in one group: rows
    (B, N) int32, r | g << 8 | b << 16 in any fixed byte order, -1 where the
    row has no point; eps2 (B,) f32.  Validity is derived from the rows, so a
    caller uploads one tensor per bucket."""
    b, n = rows.shape
    dev = rows.device
    if rows.dtype != torch.int32 or eps2.dtype != torch.float32 or eps2.shape != (b,):
        raise ValueError("eps_components_packed: expected (B, N) int32 rows and (B,) f32 eps2")
    if dev.type == "cuda":
        if eps2.device != dev or not (rows.is_contiguous() and eps2.is_contiguous()):
            raise ValueError("eps_components_packed takes contiguous tensors on one device")
        return _components_cuda(b, n, dev, None, rows, None, None, eps2)
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    points = torch.stack([(safe >> s) & 0xFF for s in (0, 8, 16)], dim=-1).float()
    return eps_components_rows(points, valid, torch.zeros_like(rows), eps2)
