#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RHCCQ codec on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. environment: card name and power limit, torch and CUDA versions, TF32
     switches, the libdeflate the container loads;
  2. build: the native host runtime (g++) and both CUDA kernels (one nvcc
     per source, started together), with the seconds each took;
  3. kernel 1 (SLIC assign) against its plain version at main-path shapes
     (B=8, MP=196,608, K=256, with 1e6 sentinel centres): ids must be equal;
  4. kernel 2 (eps sweep) and its driver against the plain versions at the
     bucket shapes (B, N) = (64, 1024), (16, 4096), (4, 10240), and against
     the host union-find: labels must be equal;
  5. end to end: encode + decode of 4 synthetic 768x512 images (Kodak's
     shape) through the public `encode`/`decode` on the card, with both
     kernels' launch counts read around that run; checks shape, PSNR > 28 dB,
     and agreement with the port's own CPU encode;
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
    check(n_diff == 0, f"slic_assign disagrees with its plain version at {n_diff} pixels")
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


def check_eps_sweep(device, shapes=((64, 1024), (16, 4096), (4, 10240)), reps=10):
    import numpy as np
    import torch

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import epscc as EPS

    recs = []
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
        t0 = time.perf_counter()
        labels, sweeps = EPS.eps_components_rows(pts, valid, groups, eps2)
        if device.type == "cuda":
            torch.cuda.synchronize()
        driver_s = time.perf_counter() - t0
        ref_labels, ref_sweeps = EPS.eps_components_rows(
            pts, valid, groups, eps2, sweep=EPS.eps_sweep_ref
        )
        check(bool((labels == ref_labels).all()), f"eps driver disagrees with the plain driver at {(b, n)}")
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
            f"eps driver disagrees with the host union-find at {(b, n)}",
        )
        rec = {"shape": [b, n], "sweeps": sweeps, "driver_ms": driver_s * 1e3,
               "max_abs_err": float((got.long() - want.long()).abs().max())}
        ops = b * n * n * 12.0
        nbytes = b * n * (12 + 4 + 1 + 4) + b * 4 + b * n * 4
        rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
        if device.type == "cuda":
            rec["ms"] = time_cuda(lambda: EPS.eps_sweep(pts, lab0, valid_u8, groups, eps2), reps)
            rec["plain_ms"] = time_cuda(
                lambda: EPS.eps_sweep_ref(pts, lab0, valid_u8, groups, eps2), max(2, reps // 5), 1
            )
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
    SA.launches = 0
    EPS.launches = 0
    datas, secs = [], []
    for img in images:
        t0 = time.perf_counter()
        datas.append(rtt.encode(img, device=device))
        secs.append(time.perf_counter() - t0)
    launches = {"slic_assign": SA.launches, "eps_sweep": EPS.launches}
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
    return results, launches, stages


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
    k1 = check_slic_assign(device)
    print(f"[slic_assign] B,MP,K={k1['shape']}: ids equal; kernel {k1['ms']:.3f} ms, "
          f"plain {k1['plain_ms']:.3f} ms, cdist+argmin {k1['library_ms']:.3f} ms, "
          f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}) [{card}]")

    # -- 4. kernel 2 -------------------------------------------------------------
    k2 = check_eps_sweep(device)
    for r in k2:
        print(f"[eps_sweep] B,N={r['shape']}: labels equal (kernel, plain, union-find); "
              f"{r['ms']:.3f} ms/sweep, plain {r['plain_ms']:.3f} ms/sweep, "
              f"{r['sweeps']} sweeps/call, driver {r['driver_ms']:.1f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")

    # -- 5. end to end ------------------------------------------------------------
    results, launches, stages = run_end_to_end(device)
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    print(f"[e2e] launches over 4 encodes: {launches}")
    for i, r in enumerate(results):
        print(f"[e2e] image {i}: {json.dumps(r)} [{card}]")
    mean_s = sum(r["seconds"] for r in results) / len(results)
    print(f"[e2e] warm seconds per 768x512 image: {mean_s:.3f} [{card}]")
    for name, st in stages.items():
        print(f"[e2e] stage {name}: {st['seconds']:.3f} s over {st['calls']} calls [{card}]")

    # -- 6. kernels line -------------------------------------------------------------
    big = k2[-1]
    kernels = [
        {k: k1[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches["slic_assign"], "max_abs_err": k1["max_abs_err"],
           "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
           "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "eps_sweep", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/epscc.cu",
         "replaces": "roibasedimagecompression_tpu/ops/pallas/epscc.py:33",
         "launches": launches["eps_sweep"], "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
