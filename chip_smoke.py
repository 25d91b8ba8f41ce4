#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RHCCQ codec on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. environment: card name and power limit, torch and CUDA versions, TF32
     switches, the libdeflate the container loads;
  2. build: the native host runtime (g++) and both CUDA kernels (one nvcc
     per source, started together), with the seconds each took;
  3. kernel 1 (SLIC assign) against its plain version at main-path shapes
     (B=8, MP=196,608, K=256 and B=1, MP=221,184, K=64, with 1e6 sentinel
     centres): ids must be equal
     (an id may differ only where the two candidates' distances are within
     one ulp: the plain version emulates the fused multiply-add in float64);
  4. kernel 2 (eps sweep) against its plain version, and the loop kernel
     against the plain loop and the host union-find, at the bucket shapes
     (B, N) = (64, 1024), (16, 4096), (4, 10240): labels must be equal.  It
     also counts the kernels, copies and synchronisations of one loop call.
     Then the entry the tiers call, `eps_components_packed` (rows of packed
     colours, -1 where a row has no point), at shapes the 4 encodes of phase 5
     launch, (B, N) = (7, 9999), (26, 1024), (1, 64), against the plain loop
     and the host union-find;
  5. end to end: encode + decode of 4 synthetic 768x512 images (Kodak's
     shape) through the public `encode`/`decode` on the card, with both
     kernels' launch counts and launch shapes read around that run; checks
     shape, PSNR > 28 dB, and agreement with the port's own CPU encode; then
     the same 4 encodes once more inside a profiler window, for the share of
     the window in which the card ran nothing;
  6. one JSON line of kernel measurements, then the card line, then the
     final {"ok": true, ...} line.

Without CUDA, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks: float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def bound_ms(ops: float, nbytes: float):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_cuda(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Kernel checks (shape arguments let a CPU rehearsal run them small).
# ---------------------------------------------------------------------------

def slic_inputs(device, b=8, mp=196_608, k=256, seed=0):
    """Features and centres in SLIC's ranges: Lab plus scaled coordinates;
    the last quarter of each row's centres carry the 1e6 sentinel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    feats = np.empty((b, mp, 5), np.float32)
    feats[..., 0] = rng.uniform(0, 100, (b, mp))
    feats[..., 1:3] = rng.uniform(-60, 60, (b, mp, 2))
    feats[..., 3:5] = rng.uniform(0, 250, (b, mp, 2))
    centers = feats[:, rng.choice(mp, k, replace=False)].copy()
    centers[:, 3 * k // 4 :] = 1e6
    return (torch.from_numpy(feats).to(device), torch.from_numpy(centers).to(device))


def check_slic_assign(device, b=8, mp=196_608, k=256, reps=20):
    import torch

    from roibasedimagecompression_torch.ops.cuda import slic_assign as SA

    feats, centers = slic_inputs(device, b, mp, k)
    got = SA.slic_assign(feats, centers)
    want = SA.slic_assign_ref(feats, centers)
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    if n_diff:
        # The plain version's fused multiply-add rounds twice (float64, then
        # float32), so a distance can be one ulp off the card's.
        bb, pp = torch.nonzero(got != want, as_tuple=True)
        f64, c64 = feats[bb, pp].double(), centers.double()
        for ids, who in ((got, "kernel"), (want, "plain")):
            d2 = ((f64 - c64[bb, ids[bb, pp].long()]) ** 2).sum(-1)
            print(f"[slic_assign] differing ids, {who}: {ids[bb, pp][:8].tolist()} d2 {d2[:8].tolist()}")
        d2g = ((f64 - c64[bb, got[bb, pp].long()]) ** 2).sum(-1).float()
        d2w = ((f64 - c64[bb, want[bb, pp].long()]) ** 2).sum(-1).float()
        ulp = torch.maximum(d2g, d2w) * 2.0**-23
        check(bool(((d2g - d2w).abs() <= ulp).all()),
              f"slic_assign disagrees with its plain version at {n_diff} pixels by more than one ulp")
    check(int(got.max()) < 3 * k // 4, "a sentinel centre won an assignment")
    rec = {
        "name": "slic_assign", "route": "cuda",
        "source": "roibasedimagecompression_torch/csrc/slic_assign.cu",
        "replaces": "roibasedimagecompression_tpu/ops/pallas/slic_assign.py:32",
        "max_abs_err": float((got.long() - want.long()).abs().max()),
        "shape": [b, mp, k],
    }
    ops = b * mp * k * 17.0
    nbytes = b * mp * 5 * 4 + b * k * 5 * 4 + b * mp * 4
    rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
    if device.type == "cuda":
        rec["ms"] = time_cuda(lambda: SA.slic_assign(feats, centers), reps)
        rec["plain_ms"] = time_cuda(lambda: SA.slic_assign_ref(feats, centers), max(2, reps // 10), 1)
        rec["library_ms"] = time_cuda(
            lambda: torch.cdist(feats, centers).argmin(-1), max(2, reps // 10), 1
        )
    return rec


def eps_inputs(device, b, n, seed=0):
    """Integer colours in clumps (so components of several sizes form),
    per-row eps from the quality law's range, two groups per row (first and
    second half), and a ragged valid prefix per row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 256, (b, 12, 3))
    pick = rng.integers(0, 12, (b, n))
    pts = np.clip(
        np.take_along_axis(centers, pick[..., None].repeat(3, -1), 1)
        + rng.integers(-24, 25, (b, n, 3)), 0, 255,
    ).astype(np.float32)
    sizes = rng.integers(n // 2, n + 1, b)
    sizes[0] = n
    valid = np.arange(n)[None, :] < sizes[:, None]
    groups = (np.arange(n)[None, :] >= (sizes[:, None] // 2)).astype(np.int32)
    groups = np.where(valid, groups, -1).astype(np.int32)
    eps = rng.choice([10.0, 51.2, 102.4, 115.2], b)
    eps2 = (eps.astype(np.float32) ** 2).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(pts), t(valid), t(groups), t(eps2), (pts, sizes, eps)


def median_ms(fn, reps=5) -> float:
    """Median host-clock milliseconds of `fn`, which must end synchronised."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def count_device_calls(fn) -> dict:
    """Kernels, copies/memsets and host synchronisations of one call of `fn`,
    read from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, copies, syncs = [], 0, 0
    for ev in prof.events():
        on_card = ev.device_type == torch.autograd.DeviceType.CUDA
        name = ev.name
        if on_card and name.lower().startswith(("memcpy", "memset")):
            copies += 1
        elif on_card:
            kernels.append(name.split("<")[0].split("(anonymous namespace)::")[-1].split("(")[0][-40:])
        elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"):
            syncs += 1
    return {"kernels": kernels, "copies": copies, "syncs": syncs - 1}  # less the closing one


def sorted_eps_inputs(device, b, n, eps=64.0, seed=1):
    """Distinct random colours sorted by packed value, one group, every point
    valid: the order in which the tiers hand a run to the loop."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    packed = np.stack([np.sort(rng.choice(1 << 24, n, replace=False)) for _ in range(b)])
    pts = np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], -1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(pts), t(np.ones((b, n), bool)), t(np.zeros((b, n), np.int32)),
            t(np.full(b, np.float32(eps) ** 2, np.float32)))


def check_eps_sweep(device, shapes=((64, 1024), (16, 4096), (4, 10240)), reps=10):
    import numpy as np
    import torch

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import epscc as EPS

    on_card = device.type == "cuda"
    recs = []
    # First-use costs of the plain loop's torch ops stay out of its times.
    pts, valid, groups, eps2, _ = eps_inputs(device, 2, 64)
    EPS.eps_components_rows(pts, valid, groups, eps2, sweep=EPS.eps_sweep_ref)
    for b, n in shapes:
        pts, valid, groups, eps2, (pts_np, sizes, eps) = eps_inputs(device, b, n)
        valid_u8 = valid.to(torch.uint8)
        lab0 = torch.where(
            valid, torch.arange(n, dtype=torch.int32, device=device).expand(b, n),
            torch.full((b, n), EPS.INT_MAX, dtype=torch.int32, device=device),
        ).contiguous()
        got = EPS.eps_sweep(pts, lab0, valid_u8, groups, eps2)
        want = EPS.eps_sweep_ref(pts, lab0, valid_u8, groups, eps2)
        check(bool((got == want).all()), f"eps_sweep disagrees with its plain version at {(b, n)}")
        labels, sweeps = EPS.eps_components_rows(pts, valid, groups, eps2)
        t0 = time.perf_counter()
        ref_labels, ref_sweeps = EPS.eps_components_rows(
            pts, valid, groups, eps2, sweep=EPS.eps_sweep_ref
        )
        if on_card:
            torch.cuda.synchronize()
        plain_driver_ms = (time.perf_counter() - t0) * 1e3
        check(bool((labels == ref_labels).all()), f"eps loop disagrees with the plain loop at {(b, n)}")
        # The host union-find on the same runs: one run per (row, group).
        lab_np = labels.cpu().numpy()
        packed = (
            (pts_np[..., 0].astype(np.int64) << 16) | (pts_np[..., 1].astype(np.int64) << 8)
            | pts_np[..., 2].astype(np.int64)
        ).reshape(-1).astype(np.int32)
        half = sizes // 2
        starts = np.stack([np.arange(b) * n, np.arange(b) * n + half], 1).reshape(-1)
        run_sizes = np.stack([half, sizes - half], 1).reshape(-1)
        run_eps = np.repeat(eps, 2)
        keep = run_sizes > 0
        nat = native.epscc_labels_runs(packed, starts[keep], run_sizes[keep], run_eps[keep])
        pos, _, _ = native.flat_run_positions(starts[keep], run_sizes[keep])
        offset = np.repeat((starts[keep] % n), run_sizes[keep])
        check(
            bool((lab_np.reshape(-1)[pos] == nat + offset).all()),
            f"eps loop disagrees with the host union-find at {(b, n)}",
        )
        rec = {"shape": [b, n], "sweeps": sweeps, "plain_sweeps": ref_sweeps,
               "plain_driver_ms": plain_driver_ms,
               "max_abs_err": float((got.long() - want.long()).abs().max()),
               "loop_max_abs_err": float((labels.long() - ref_labels.long()).abs().max())}
        # What this run's data needs: valid rows against valid columns, 12
        # operations a pair (3 sub, 3 mul, 3 add, 2 compares, select).
        ops = float((sizes.astype(np.float64) ** 2).sum()) * 12.0
        nbytes = b * n * (12 + 4 + 1 + 4) + b * 4 + b * n * 4
        rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
        if on_card:
            rec["ms"] = time_cuda(lambda: EPS.eps_sweep(pts, lab0, valid_u8, groups, eps2), reps)
            rec["plain_ms"] = time_cuda(
                lambda: EPS.eps_sweep_ref(pts, lab0, valid_u8, groups, eps2), max(2, reps // 5), 1
            )
            rec["driver_ms"] = median_ms(lambda: EPS.eps_components_rows(pts, valid, groups, eps2))
            rec["driver_calls"] = count_device_calls(
                lambda: EPS.eps_components_rows(pts, valid, groups, eps2)
            )
        recs.append(rec)
    # Rows sorted as the tiers sort them (the far-tile skip's case), eps = 64
    # (quality 50), at the largest bucket.
    b, n = shapes[-1]
    pts, valid, groups, eps2 = sorted_eps_inputs(device, b, n)
    labels, _ = EPS.eps_components_rows(pts, valid, groups, eps2)
    ref_labels, _ = EPS.eps_components_rows(pts, valid, groups, eps2, sweep=EPS.eps_sweep_ref)
    check(bool((labels == ref_labels).all()), "eps loop disagrees with the plain loop on sorted rows")
    return recs


def packed_eps_inputs(b, n, seed=2):
    """Rows as the tiers build them: distinct colours of one run in clumps,
    sorted by packed value, ragged (row 0 as full as its clumps allow), -1
    where the row has no point; eps of quality 90, 60, 50 and 20.  numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.full((b, n), -1, np.int32)
    sizes = np.zeros(b, np.int64)
    for r in range(b):
        want = n if r == 0 else int(rng.integers(max(1, n // 2), n + 1))
        centers = rng.integers(0, 256, (12, 3))
        pts = np.clip(centers[rng.integers(0, 12, 2 * want)] + rng.integers(-40, 41, (2 * want, 3)), 0, 255)
        packed = np.unique(pts[:, 0] | (pts[:, 1] << 8) | (pts[:, 2] << 16))
        packed = np.sort(rng.choice(packed, min(want, len(packed)), replace=False))
        rows[r, : len(packed)] = packed
        sizes[r] = len(packed)
    eps = rng.choice([12.8, 51.2, 64.0, 102.4], b)
    return rows, sizes, eps


def check_eps_packed(device, shapes=((7, 9999), (26, 1024), (1, 64))):
    """`eps_components_packed`, the entry the tiers call, at shapes the main
    path launches: the kernel's labels against the plain loop and against
    the host union-find on the same runs."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import epscc as EPS

    recs = []
    for b, n in shapes:
        rows_np, sizes, eps = packed_eps_inputs(b, n)
        eps2_np = (eps.astype(np.float32) ** 2).astype(np.float32)
        rows, eps2 = torch.from_numpy(rows_np).to(device), torch.from_numpy(eps2_np).to(device)
        labels, sweeps = EPS.eps_components_packed(rows, eps2)
        # The plain loop on the same device, on the colours unpacked to points.
        valid = rows >= 0
        safe = torch.where(valid, rows, torch.zeros_like(rows))
        points = torch.stack([(safe >> sh) & 0xFF for sh in (0, 8, 16)], dim=-1).float()
        t0 = time.perf_counter()
        ref_labels, ref_sweeps = EPS.eps_components_rows(
            points, valid, torch.zeros_like(rows), eps2, sweep=EPS.eps_sweep_ref
        )
        ref_np = ref_labels.cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lab_np = labels.cpu().numpy()
        check(bool((lab_np == ref_np).all()),
              f"eps_components_packed disagrees with the plain loop at {(b, n)}")
        starts = np.arange(b, dtype=np.int64) * n
        nat = native.epscc_labels_runs(rows_np.reshape(-1), starts, sizes, eps)
        pos, _, _ = native.flat_run_positions(starts, sizes)
        check(bool((lab_np.reshape(-1)[pos] == nat).all()),
              f"eps_components_packed disagrees with the host union-find at {(b, n)}")
        check(bool((lab_np[rows_np < 0] == n).all()), f"an absent point got a label at {(b, n)}")
        rec = {"shape": [b, n], "entry": "packed", "sweeps": sweeps, "plain_sweeps": ref_sweeps,
               "plain_driver_ms": plain_ms, "components": int((lab_np == np.arange(n)[None, :]).sum()),
               "loop_max_abs_err": float(np.abs(lab_np.astype(np.int64) - ref_np).max())}
        ops = float((sizes.astype(np.float64) ** 2).sum()) * 12.0
        nbytes = b * n * 4 + b * 4 + b * n * 4
        one, rec["bound_by"] = bound_ms(ops, nbytes)
        rec["bound_ms"] = sweeps * one
        if device.type == "cuda":
            rec["driver_ms"] = median_ms(lambda: EPS.eps_components_packed(rows, eps2))
            rec["driver_calls"] = count_device_calls(lambda: EPS.eps_components_packed(rows, eps2))
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# End to end.
# ---------------------------------------------------------------------------

def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def seg_agreement(img, device_a, device_b) -> float:
    """Share of pixels whose segment ids agree between two devices' runs of
    the ROI + segment stages (same ids up to the segment numbering)."""
    import numpy as np

    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.models import codec, roi_fused
    from roibasedimagecompression_torch.ops import canny

    config = cfg.CodecConfig()
    low, high = canny.select_thresholds_pair(img)
    roi, nonroi = roi_fused.roi_masks_fast(img, config, low, high)
    regions = codec._extract_and_assign(roi, nonroi, cfg.min_region_size(img.size))
    a = codec.build_segment_map(img, *regions, config, device_a)[0]
    b = codec.build_segment_map(img, *regions, config, device_b)[0]
    return float(np.mean(a == b))


def run_end_to_end(device, n_images=4, h=512, w=768, compare_cpu=True):
    import numpy as np
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch.ops.cuda import epscc as EPS
    from roibasedimagecompression_torch.ops.cuda import slic_assign as SA
    from roibasedimagecompression_torch.utils import timing
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    images = [synthetic_image(100 + i, h, w) for i in range(n_images)]
    rtt.encode(images[0], device=device)  # warm-up: first-use builds, allocator
    if device.type == "cuda":
        torch.cuda.synchronize()
    timing.reset_stages()
    SA.launches = EPS.launches = EPS.sweep_launches = EPS.rounds = 0
    SA.launch_shapes.clear()
    EPS.loop_shapes.clear()
    datas, secs = [], []
    for img in images:
        t0 = time.perf_counter()
        datas.append(rtt.encode(img, device=device))
        secs.append(time.perf_counter() - t0)
    launches = {"slic_assign": SA.launches, "eps_components": EPS.launches,
                "eps_sweep_alone": EPS.sweep_launches, "eps_rounds": EPS.rounds}
    shapes = {
        "slic_assign (B, MP, K)": {str(k): v for k, v in sorted(SA.launch_shapes.items())},
        "eps loop (B, N)": {str(k): v for k, v in sorted(EPS.loop_shapes.items())},
    }
    stages = timing.stage_report()
    results = []
    for img, data, s in zip(images, datas, secs):
        out = rtt.decode(data)
        check(out.shape == img.shape, f"decoded shape {out.shape} != {img.shape}")
        p = psnr(img, out)
        check(p > 28.0, f"PSNR {p:.2f} dB is below the 28 dB floor")
        results.append({"seconds": s, "psnr_db": p, "bpp": len(data) * 8 / (h * w)})
    if compare_cpu and device.type == "cuda":
        cpu = torch.device("cpu")
        for i, (img, data) in enumerate(zip(images, datas)):
            ref = rtt.encode(img, device=cpu)
            r = results[i]
            r["bytes_equal_cpu"] = data == ref
            if data != ref:
                r["seg_agreement_cpu"] = seg_agreement(img, device, cpu)
                r["dpsnr_cpu"] = r["psnr_db"] - psnr(img, rtt.decode(ref))
                r["dbpp_rel_cpu"] = (len(data) - len(ref)) / len(ref)
                check(
                    r["seg_agreement_cpu"] >= 0.995 and abs(r["dpsnr_cpu"]) <= 0.05
                    and abs(r["dbpp_rel_cpu"]) <= 0.01,
                    f"image {i}: CUDA encode departs from the CPU encode: {r}",
                )
    idle = device_idle_share(lambda: [rtt.encode(img, device=device) for img in images]) \
        if device.type == "cuda" else None
    return results, launches, shapes, stages, idle


def device_idle_share(fn) -> dict:
    """Run `fn` inside one profiler window and return the window's length on
    the host clock, the time in which at least one kernel or copy ran on the
    card (union of their intervals), and the share in which none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    )
    check(len(spans) > 0, "the profiler window recorded no work on the card")
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3, "device_events": len(spans),
            "idle_share": 1.0 - busy_us / window_us}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "roibasedimagecompression_torch")):
        print("chip_smoke: the roibasedimagecompression_torch package is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.utils import device as DEV

    device = DEV.resolve(None)
    card = card_line()
    # -- 1. environment ------------------------------------------------------
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"[env] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    _, ld_name = native.libdeflate()
    print(f"[env] deflate: {ld_name or 'zlib (libdeflate not found; levels > 9 use zlib 9)'}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    native.build()
    print(f"[build] native runtime (g++): {time.perf_counter() - t0:.2f} s")
    secs = _build.build_all()
    for name, s in secs.items():
        print(f"[build] {name}.cu (nvcc, parallel): {s:.2f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # -- 3. kernel 1 -------------------------------------------------------------
    # The batch shape of a full SLIC bucket, and the shape the 4 encodes of
    # phase 5 launch most (one 768x512 region, 64 centres).
    k1, k1_single = check_slic_assign(device), check_slic_assign(device, b=1, mp=221_184, k=64)
    for r in (k1, k1_single):
        print(f"[slic_assign] B,MP,K={r['shape']}: ids equal; kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, cdist+argmin {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")

    # -- 4. kernel 2 -------------------------------------------------------------
    k2, k2_packed = check_eps_sweep(device), check_eps_packed(device)
    for r in k2:
        print(f"[eps_sweep] B,N={r['shape']}: labels equal (kernel, plain, union-find); "
              f"{r['ms']:.3f} ms/sweep, plain {r['plain_ms']:.3f} ms/sweep, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    for r in k2 + k2_packed:
        calls = r["driver_calls"]
        print(f"[eps_loop] {r.get('entry', 'points')} B,N={r['shape']}: {r['sweeps']} rounds on the card "
              f"(plain loop {r['plain_sweeps']}, {r['plain_driver_ms']:.1f} ms), "
              f"driver {r['driver_ms']:.3f} ms/call; one call = "
              f"{len(calls['kernels'])} kernels {calls['kernels']}, {calls['copies']} copies/memsets, "
              f"{calls['syncs']} host synchronisations [{card}]")
        check(len(calls["kernels"]) <= 4 and calls["syncs"] <= 2,
              f"the eps loop at {r['shape']} ran {calls} for {r['sweeps']} rounds: it is not on the card")

    # -- 5. end to end ------------------------------------------------------------
    results, launches, shapes, stages, idle = run_end_to_end(device)
    for name in ("slic_assign", "eps_components", "eps_rounds"):
        check(launches[name] > 0, f"the main path launched {name} no time")
    print(f"[e2e] launches over 4 encodes: {launches}")
    for name, hist in shapes.items():
        print(f"[e2e] launch shapes, {name}: {json.dumps(hist)}")
    print(f"[e2e] profiler window over the 4 warm encodes: {json.dumps(idle)} [{card}]")
    for i, r in enumerate(results):
        print(f"[e2e] image {i}: {json.dumps(r)} [{card}]")
    mean_s = sum(r["seconds"] for r in results) / len(results)
    print(f"[e2e] warm seconds per 768x512 image: {mean_s:.3f} [{card}]")
    for name, st in stages.items():
        print(f"[e2e] stage {name}: {st['seconds']:.3f} s over {st['calls']} calls [{card}]")

    # -- 6. kernels line -------------------------------------------------------------
    big, big_packed = k2[-1], k2_packed[0]
    kernels = [
        {k: k1[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches["slic_assign"], "max_abs_err": k1["max_abs_err"],
           "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
           "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
           "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                         for r in (k1, k1_single)]},
        {"name": "eps_sweep", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/epscc.cu",
         "replaces": "roibasedimagecompression_tpu/ops/pallas/epscc.py:33",
         # On the main path the sweep's code runs inside the loop kernel
         # (eps_components_kernel), so `launches` are that kernel's, counted
         # beside its launch; the sweep kernel alone (eps_sweep_kernel, which
         # `ms` times) is launched by no encode.
         "launches": launches["eps_components"], "launches_alone": launches["eps_sweep_alone"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None,
         "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")} for r in k2]},
        {"name": "eps_components", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/epscc.cu",
         "replaces": "roibasedimagecompression_tpu/ops/pallas/epscc.py:97",
         "launches": launches["eps_components"], "rounds": launches["eps_rounds"],
         "max_abs_err": max(r["loop_max_abs_err"] for r in k2 + k2_packed),
         # One call of the driver (pack, loop kernel, read-back) through the
         # entry and at the largest shape the encodes use; its bound is this
         # call's count of rounds times one sweep's bound.
         "ms": big_packed["driver_ms"], "plain_ms": big_packed["plain_driver_ms"],
         "bound_ms": big_packed["bound_ms"], "bound_by": big_packed["bound_by"],
         "library_ms": None,
         "per_shape": [{"shape": r["shape"], "entry": "points", "sweeps": r["sweeps"],
                        "driver_ms": r["driver_ms"], "plain_driver_ms": r["plain_driver_ms"],
                        "bound_ms": r["sweeps"] * r["bound_ms"]} for r in k2]
                      + [{k: r[k] for k in ("shape", "entry", "sweeps", "components", "driver_ms",
                                            "plain_driver_ms", "bound_ms")} for r in k2_packed]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
