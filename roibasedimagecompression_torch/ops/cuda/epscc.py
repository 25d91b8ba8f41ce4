"""eps-graph connected components (DBSCAN, min_samples=1) over palette rows.

`eps_sweep` is one masked-min label sweep (kernel `csrc/epscc.cu`, the
counterpart of the JAX package's Pallas `eps_sweep_pallas`); on a CPU tensor
it runs the plain version `eps_sweep_ref`.  `eps_components_rows` is the
driver of `eps_components_pallas`: min-combine, ceil(log2 m) pointer-jump
hops, and the loop until no label changes (one host sync per round).
"""

from __future__ import annotations

import torch

from roibasedimagecompression_torch.ops.cuda import _build

INT_MAX = 2**31 - 1

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


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


def eps_sweep(points, labels, valid, groups, eps2) -> torch.Tensor:
    """One sweep: points (B, N, 3) f32, labels/groups (B, N) int32, valid
    (B, N) uint8, eps2 (B,) f32 -> (B, N) int32 (INT_MAX where no neighbor)."""
    global launches
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
    lib = _build.load("epscc")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eps_sweep_launch(points.data_ptr(), labels.data_ptr(), valid.data_ptr(),
                groups.data_ptr(), eps2.data_ptr(), out.data_ptr(), b, n, stream)
    _build.check(lib, rc, "eps_sweep")
    launches += 1
    return out


def eps_components_rows(points, valid, groups, eps2, sweep=eps_sweep):
    """Connected components of each row's eps-graph.

    points (B, N, 3) f32, valid (B, N) bool, groups (B, N) int32 (edges join
    equal groups >= 0 only), eps2 (B,) f32.  Returns ((B, N) int32 labels,
    sweeps): each component carries its minimum point index; invalid points
    get N.  `sweep` is eps_sweep or, for a plain run on any device,
    eps_sweep_ref.
    """
    b, n = valid.shape
    dev = points.device
    groups = torch.where(valid, groups, torch.full_like(groups, -1)).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    int_max = torch.full((b, n), INT_MAX, dtype=torch.int32, device=dev)
    lab = torch.where(valid, idx, int_max).contiguous()
    n_hops = max(1, (n - 1).bit_length())
    sweeps = 0
    for _ in range(n):
        proposed = sweep(points, lab, valid_u8, groups, eps2)
        sweeps += 1
        new = torch.where(valid, torch.minimum(lab, proposed), int_max)
        for _ in range(n_hops):
            safe = torch.where(new < n, new, torch.zeros_like(new)).long()
            new = torch.where(valid, torch.minimum(new, torch.gather(new, 1, safe)), int_max)
        changed = bool((new != lab).any())
        lab = new.contiguous()
        if not changed:
            break
    return torch.where(lab == INT_MAX, torch.full_like(lab, n), lab), sweeps
