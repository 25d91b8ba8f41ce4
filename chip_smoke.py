#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RHCCQ codec on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. environment: card name and power limit, torch and CUDA versions, TF32
     switches, the libdeflate the container loads;
  2. build: the native host runtime (g++) and the four CUDA kernel
     sources (one nvcc per source, started together), with the seconds each
     took;
  3. kernel 1 (SLIC assign), in both its forms (the expanded form of the
     JAX package's default and the direct form of its Pallas kernel), against
     its plain version at the (B, MP, K) the paths below launch (the batch
     path's (8, 221184, 64) first; K = 64 throughout) and at a full bucket of
     the widest K, (8, 196608, 256), which none of them launches; invalid
     centres (1e6 sentinel, masked in the expanded form); ids must be equal
     (an id may differ only where the two candidates' distances are within
     one ulp: the plain version emulates the fused multiply-add in float64);
     and the k-means++ logarithm `log32` on the card against the CPU, bit for
     bit; then kernel 3 (the k-means++ Gumbel noise) against its plain
     version, the host table `_gumbel_table`, bit for bit, at the (n_draws,
     m) the cells draw most, (256, 16384) and (64, 65536), at a short row
     and at tails of a block's tile, timed by CUDA events (launches queued
     behind a sleep, so the host's launch rate is not timed) against its
     integer-instruction bound; then kernel 4 (the k-means++ seeding)
     against its plain version, the Python step a centre `_plusplus_loop` on
     the card, bit for bit, at tier 1's (1, 16384, 142) and (1, 32768, 189)
     and a split bucket (128, 1024, 16), timed (queued, and a step's time)
     beside the loop's card and host time; phases 5, 7 and 8 check that
     every seeding was one launch of it and none took the loop;
  4. kernel 2 (eps sweep) against its plain version, and the loop kernel
     against the plain loop and the host union-find, at the bucket shapes
     (B, N) = (64, 1024), (16, 4096), (4, 10240): labels must be equal.  It
     also counts the kernels, copies and synchronisations of one loop call.
     Then the entry the tiers call, `eps_components_packed` (rows of packed
     colours, -1 where a row has no point), at shapes the encodes launch:
     (B, N) = (7, 9999), (26, 1024), (1, 64) of the one-image path, and the
     batch paths' tall ones, (48, 9999), (17, 4096), (126, 4096), (245, 1024),
     against the plain loop and the host union-find;
     every loop shape is also timed by CUDA events around the pack and loop
     kernels alone, beside the host-clock time of a whole call of the loop;
  5. one image at a time: encode + decode of 2 synthetic 768x512 images
     (Kodak's shape) through the public `encode`/`decode` on the card, with
     every kernel's launch counts and launch shapes read around that run;
     checks shape, PSNR > 28 dB, and agreement with the port's own CPU
     encode; then the same encodes once more inside a profiler window, for
     the share of the window in which the card ran nothing;
  6. pairs: on the tall map of 8 such images (seeds 100-107) and their real
     segment maps, the device pair table against the host runtime: `uniq`,
     `counts`, the post-repair colors, the painted index map and the refit
     rows, all exact; sort, compact, paint and refit times by CUDA events;
  7. batch: `encode_many` of those 8 images at `CodecConfig()` on the card,
     counts read around it: bytes of the first 2 against the CPU `encode_many`
     of those 2 (equal, else segment maps >= 99.5 %, |dPSNR| <= 0.05 dB,
     |size| <= 1 %), all 8 equal with
     RHCCQ_DEVICE_PAIRS=0, every image above 28 dB, PSNR and SSIM, stage
     seconds, launch shapes, idle share; the same once at
     `CodecConfig.low_latency()`;
  8. stream: `encode_stream` of 3 batches of 8 with workers=2 against three
     sequential `encode_many` calls, byte for byte, under a deadline (a hang
     of the cooperative kernel under two threads ends the run non-zero);
  9. cli: the two images of phase 5 written as PNGs in the layout the
     `sweep` subcommand reads; `python3 -m roibasedimagecompression_torch
     encode` once as a subprocess (at CodecConfig()'s split margin, so its
     bytes must equal phase 5's), then in process, counts read around each:
     `encode` at the CLI's defaults and with `--split-method mediancut`,
     `--split-method kmeans-mc`, `--enhance-shadows`, `--container-level 7`,
     each against the same command with `--device cpu` (the phase-7 rule);
     `decode` to PNG, `eval` and `eval --adaptive` (PSNR above 28 dB and
     equal to `quality_metrics` on the card), `sweep` (2 CSV rows) and
     `compare` against a JPEG baseline; seconds of each subcommand;
 10. canvas: the canvas tiers path on the card, counts read around each run:
     `encode` of phase 5's 2 images and `encode_many` of the first 4 of
     phase 7's batch under RHCCQ_CANVAS_TIERS=1, byte for byte equal to
     phases 5 and 7 (the composed path), then both at fill_black_holes=10,
     one image held to the CPU encode; and one `encode` under
     RHCCQ_SLIC_PALLAS=1 (kernel 1's direct form) against the CPU;
 11. loop: the reference-shaped loop (`CodecConfig(batched=False)`) on
     phase 5's first image, at `single_region=True` and with its ROI
     frontend, counts read around each encode (both kernels must launch),
     each byte for byte equal to the CPU encode of the same image; stage
     seconds; and the box filter of the ROI masks (k = 3, 15, 25, the order
     of XLA's CPU convolution) on the card against the CPU, bit for bit;
 12. options and the codec without its runtime: on phase 5's first image,
     `encode` at region_fusion=True and at weighted_split=True and the loop
     at both, and `encode_debug` (every intermediate), each against the CPU,
     byte for byte; then, in a child process (`--nonative-child`) under
     RHCCQ_NATIVE=0 (read once per process): `encode` of that image and
     the loop, each against the same call on the CPU under the switch, byte
     for byte, and `encode_many` of the batch's first two (held by phase 15
     against the JAX package's digests), with counts,
     stage seconds and connected-components passes read around each, then
     `encode` of seed 102 for phase 15 (by digest only), and the
     propagation's card time per pass;
 13. side modules, on the third image of phase 7's batch (seed 102; the
     first two have no ROI pixels at CodecConfig()) and its ROI mask, each on the
     card against the same call on the CPU: Zhang-Suen thinning, the five
     connect strategies (Voronoi on the mask sampled every 8th pixel: its
     cells are host geometry, quadratic in the points), the legacy thin
     structure filter and the watershed, all equal; the bilateral filter
     (equal, or at most 1 level on at most 0.1 % of the pixels); spline
     compression of the longest SLIC segment boundary (host); card seconds
     of each;
 14. entry surface: `entry()`'s core (256 x 256) and `analysis_step` of
     that image at 768x512 (8 x 8 centres, 4096 palette slots) on the card
     against the CPU, all nine outputs equal; `batched_analysis_step` of the
     8 batch images on the card, equal to each image's own call; warm
     seconds, both kernels' counts and shapes; `encode_many` of the 8 and
     `encode_stream` of 2 batches on a mesh of ["cuda:0"] * 2 (and of every
     card when there are more), byte-equal to phases 7 and 8 without a
     mesh; `dryrun_multichip(2, devices=["cuda:0"] * 2)`; a `device_trace`
     of one encode holding a kernel event; one operation-counted
     `encode_many` of 8 (executed operations, wall, share of the card's
     float32 peak); `identity_report()` and the build pack's freshness
     before and after `prewarm`;
 15. parity with the JAX package: the payload digests (sha256 of the
     unpacked palette, index matrix and shape) of the 768x512 encodes of
     phases 5, 7 and 9-12 against the JAX package's, read from
     tests/data/jax_parity_768x512.json (written by
     scripts/port_parity_fullsize.py; this script imports no JAX): equal,
     or, where the earlier phase took its allowance against the CPU, PSNR
     within 0.05 dB of the file's; then new card encodes of seed 102 (the
     first with ROI pixels) at the rows no phase runs on it (RHCCQ_SLIC_PALLAS=1,
     the loop with and without its ROI frontend, region fusion, the weighted
     split and both, the weighted k-means split, the CLI's mediancut,
     kmeans-mc and --enhance-shadows, and phase 12's child without the
     runtime), counts read around each, each held by its digest; and the
     PSNR and SSIM of the batch's 8 decodes on the card against the file's;
 16. cover: every (form, B, MP, K), (B, N), Gumbel (seed, n_draws, m) and
     k-means++ (B, m, n_draws, k_max)
     that phases 5 and 7-15 launched and phases 3 and 4 did not check is
     checked against the plain version now, so no path runs a kernel at a
     shape the run has not held;
 17. the parity line {"parity": {"rows": n, "equal": e, "open": [...]}}, one
     JSON line of kernel measurements, then the card line, then the final
     {"ok": true, ...} line.

Without CUDA, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks: float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Integer instruction rate: 64 INT32 lanes a SM x 132 SMs x 1.98 GHz (kernel 3's bound).
PEAK_INT32_OPS = 64 * 132 * 1.98e9


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

# (B, MP, K) that `slic_assign` is checked at before the paths run: what
# encode_many launches at CodecConfig() (the first two) and at low_latency(),
# and the one-image path's (1, 221184, 64).  The cover phase checks whatever else a
# path launched, and says which of these none did.  The last is a full SLIC
# bucket at the widest K the wrapper takes, which no path of this run launches.
SLIC_PATH_SHAPES = ((8, 221_184, 64), (2, 65_536, 64), (1, 221_184, 64), (4, 81_920, 64),
                    (2, 200_704, 64), (1, 172_032, 64), (1, 102_400, 64))
SLIC_WIDEST_SHAPE = (8, 196_608, 256)
# (B, N) the packed entry of the eps loop is checked at before the paths run:
# the one-image path's largest and two small ones, then the batch paths' tall ones.
EPS_PACKED_SHAPES = ((7, 9999), (26, 1024), (1, 64), (48, 9999), (17, 4096), (126, 4096), (245, 1024))

# Every shape a path launched a kernel at (read_counts adds to it); kernel 1's
# as (form, B, MP, K).
launched_shapes = {"slic_assign": set(), "eps_components": set(), "gumbel": set(), "kmeanspp": set()}
SLIC_FORMS = ("expanded", "direct")


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


def check_slic_assign(device, form, b=8, mp=196_608, k=256, reps=20):
    """Kernel 1 in `form` ("expanded" or "direct") against its plain version
    on the same inputs; the last quarter of the centres are not valid."""
    import torch

    from roibasedimagecompression_torch.ops.cuda import slic_assign as SA

    feats, centers = slic_inputs(device, b, mp, k)
    valid = torch.arange(k, device=device)[None, :].expand(b, k) < 3 * k // 4
    if form == "expanded":
        run = lambda: SA.slic_assign_expanded(feats, centers, valid)  # noqa: E731
        plain = lambda: SA.slic_assign_expanded_ref(feats, centers, valid)  # noqa: E731
    else:
        run = lambda: SA.slic_assign(feats, centers)  # noqa: E731
        plain = lambda: SA.slic_assign_ref(feats, centers)  # noqa: E731
    got, want = run(), plain()
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
            print(f"[slic_assign {form}] differing ids, {who}: {ids[bb, pp][:8].tolist()} d2 {d2[:8].tolist()}")
        d2g = ((f64 - c64[bb, got[bb, pp].long()]) ** 2).sum(-1)
        d2w = ((f64 - c64[bb, want[bb, pp].long()]) ** 2).sum(-1)
        scale = torch.maximum(d2g, d2w)
        if form == "expanded":  # it rounds at the scale of |p|^2 + |c|^2
            c2 = (c64 * c64).sum(-1)
            scale = (f64 * f64).sum(-1) + torch.maximum(c2[bb, got[bb, pp].long()], c2[bb, want[bb, pp].long()])
        check(bool(((d2g - d2w).abs() <= scale * 2.0**-22).all()),
              f"slic_assign ({form}) disagrees with its plain version at {n_diff} pixels by more than one ulp")
    check(int(got.max()) < 3 * k // 4, f"an invalid centre won an assignment ({form})")
    expanded = form == "expanded"
    rec = {
        "name": "slic_assign_expanded" if expanded else "slic_assign", "route": "cuda", "form": form,
        "source": "roibasedimagecompression_torch/csrc/slic_assign.cu",
        "replaces": ("roibasedimagecompression_tpu/ops/slic.py:139" if expanded
                     else "roibasedimagecompression_tpu/ops/pallas/slic_assign.py:32"),
        "max_abs_err": float((got.long() - want.long()).abs().max()),
        "shape": [b, mp, k], "ids_differing": n_diff,
    }
    # Operations per pixel-centre pair: direct 5 sub, 5 mul, 4 add, compare,
    # 2 selects = 17; expanded 5 mul + 4 add (the dot), add, multiply-add,
    # compare, 2 selects = 15.
    ops = b * mp * k * (15.0 if expanded else 17.0)
    nbytes = b * mp * 5 * 4 + b * k * 5 * 4 + b * mp * 4 + (b * k if expanded else 0)
    rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
    if device.type == "cuda":
        rec["ms"] = time_cuda(run, reps)
        rec["plain_ms"] = time_cuda(plain, max(2, reps // 10), 1)
        if expanded:
            def library():
                p2 = (feats * feats).sum(-1, keepdim=True)
                c2 = torch.where(valid, (centers * centers).sum(-1), float("inf"))[:, None, :]
                return (p2 + c2 - 2 * torch.bmm(feats, centers.transpose(1, 2))).argmin(-1)
        else:
            def library():
                return torch.cdist(feats, centers).argmin(-1)
        rec["library_ms"] = time_cuda(library, max(2, reps // 10), 1)
    return rec


def check_log32(device, n=1 << 20):
    """The k-means++ logarithm on the card against the CPU, bit for bit, on
    uniforms, squared distances and nearly equal distances."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch.ops import prng

    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.random(n // 2).astype(np.float32),
        (rng.integers(0, 256, (n // 4, 3)).astype(np.float32) ** 2).sum(1),
        np.float32(4321.0) * (1 + rng.integers(-64, 64, n - n // 2 - n // 4) * np.float32(2.0**-23)),
    ]).astype(np.float32) + np.float32(1e-20)
    got = prng.log32(torch.from_numpy(x).to(device)).cpu().numpy()
    want = prng.log32(x)
    n_diff = int((got.view(np.int32) != want.view(np.int32)).sum())
    check(n_diff == 0, f"log32 on the card differs from the CPU in {n_diff} of {len(x)} values")
    return len(x)


# (n_draws, m) kernel 3 is checked at before the paths run: PERF.md's
# reference sizes (the widest k-means++ draw, 256 centres, on a 16384-colour
# row, and 64 centres on a 65536-colour row; 4.2 M elements each), a short
# table, and widths that end inside a block's tile.  The cover phase checks
# every (seed, n_draws, m) a path drew beyond these.
GUMBEL_SHAPES = ((256, 16_384), (64, 65_536), (16, 16_384), (3, 1000), (1, 8))
GUMBEL_SEED = 42  # CodecConfig's k-means seed


def time_queued_ms(fn, reps: int = 100) -> float:
    """Mean card milliseconds per call of `fn` over `reps` calls launched
    behind a sleep kernel, by CUDA events: the card runs the calls back to
    back, so a kernel shorter than its launch's host time is timed alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms: longer than queueing `reps` launches
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_gumbel(device, seed, n, m, timed=True):
    """Kernel 3 at (n_draws, m) against its plain version, the host table,
    bit for bit; with `timed`, its card time and the host table's."""
    import numpy as np

    from roibasedimagecompression_torch.ops import cluster as TCL
    from roibasedimagecompression_torch.ops.cuda import gumbel as GUMBEL

    got = GUMBEL.gumbel_table(seed, m, n, device).cpu().numpy()
    TCL._gumbel_table.cache_clear()
    t0 = time.perf_counter()
    want = TCL._gumbel_table(seed, m, n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    TCL._gumbel_table.cache_clear()
    n_diff = int((got.view(np.int32) != want.view(np.int32)).sum())
    check(n_diff == 0, f"the Gumbel kernel differs from the host table in {n_diff} of {n * m} "
                       f"elements at seed {seed}, (n_draws, m) = ({n}, {m})")
    # About 82 integer operations an element (threefry's 20 rounds and 5
    # injections, the mantissa trick, two exponent extractions, the index);
    # 4 bytes written an element and 8 read a row.
    t_ops = 82.0 * n * m / PEAK_INT32_OPS * 1e3
    t_bytes = (4.0 * n * m + 8 * n) / PEAK_BYTES * 1e3
    rec = {"shape": [n, m], "seed": seed, "bits_differing": n_diff, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "integer operations" if t_ops >= t_bytes else "bytes"}
    if timed and device.type == "cuda":
        rec["ms"] = time_queued_ms(lambda: GUMBEL.gumbel_table(seed, m, n, device))
    return rec


# (B, m, n_draws, k_max) kernel 4 is checked at before the paths run: tier 1's
# seedings (one row of 16,384 and one of 32,768 colours, at k 142 and 189) and
# a split bucket of narrow rows.  The cover phase checks every (B, m, n_draws,
# k_max) a path launched beyond these.
KMEANSPP_SHAPES = ((1, 16_384, 142, 256), (1, 32_768, 189, 256), (128, 1_024, 16, 16))


def kmeanspp_inputs(device, b, m, n_draws, k_max, seed=0):
    """Integer colours in clumps, a ragged valid prefix a row, k = n_draws in
    row 0 and 1..n_draws in the others, and kernel 3's noise."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch.ops.cuda import gumbel as GUMBEL

    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 256, (b, 40, 3))
    pick = rng.integers(0, 40, (b, m))
    pts = np.clip(np.take_along_axis(centers, pick[..., None].repeat(3, -1), 1)
                  + rng.integers(-30, 31, (b, m, 3)), 0, 255).astype(np.float32)
    valid = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, b)[:, None]
    valid[0] = True
    pts[~valid] = 0.0
    ks = rng.integers(1, n_draws + 1, b)
    ks[0] = n_draws
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(pts), t(valid), t(ks.astype(np.int64)), GUMBEL.gumbel_table(GUMBEL_SEED, m, n_draws, device)


def check_kmeanspp(device, b, m, n_draws, k_max, timed=True):
    """Kernel 4 at (B, m, n_draws, k_max) against its plain version, the
    Python step a centre (`ops/cluster.py _plusplus_loop`) on the same card,
    bit for bit; with `timed`, the kernel's card time (queued), its time a
    step (against a one-step seeding of the same rows), the loop's card time
    and its host time."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch.ops import cluster as TCL
    from roibasedimagecompression_torch.ops.cuda import kmeanspp as KPP

    pts, valid, ks, noise = kmeanspp_inputs(device, b, m, n_draws, k_max)
    table = TCL._log32_table(device)
    run = lambda: KPP.kmeanspp_centers(pts, valid, ks, noise, table, k_max)  # noqa: E731
    plain = lambda: TCL._plusplus_loop(pts, valid, ks, noise, table, k_max)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    n_diff = int((got.cpu().numpy().view(np.int32) != want.cpu().numpy().view(np.int32)).sum())
    check(n_diff == 0, f"the k-means++ kernel differs from the plain loop in {n_diff} of {got.numel()} "
                       f"centre values at (B, m, n_draws, k_max) = ({b}, {m}, {n_draws}, {k_max})")
    # 12 operations a point and step after the first, 2 in the first; the
    # points, valid flags and used noise rows read once, the centres written.
    steps = int(torch.clamp(ks, 1, min(n_draws, k_max)).sum())
    ops = 12.0 * m * (steps - b) + 2.0 * m * b
    nbytes = 13.0 * b * m + 4.0 * min(n_draws, k_max) * m + 8.0 * b + 12.0 * b * k_max
    rec = {"shape": [b, m, n_draws, k_max], "plan": list(KPP.plan(m)), "values_differing": n_diff}
    rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
    if timed:
        ones = torch.ones_like(ks)
        rec["ms"] = time_queued_ms(run, reps=50)
        one_step = time_queued_ms(lambda: KPP.kmeanspp_centers(pts, valid, ones, noise, table, k_max), reps=50)
        rec["step_us"] = (rec["ms"] - one_step) * 1e3 / max(1, min(n_draws, k_max) - 1)
        rec["plain_ms"] = time_cuda(plain, reps=3, warmup=1)
        t0 = time.perf_counter()
        plain()
        rec["plain_host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
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


def count_device_calls(fn, tries=3) -> dict:
    """Kernels, copies/memsets and host synchronisations of one call of `fn`,
    read from a profiler trace, and the loop kernel's launches by the launch
    record.  The profiler now and then hands back a trace of so short
    a window without the card's kernels (the host's side is there, sometimes
    a copy); every call launches at least one kernel, so such a trace is
    incomplete: it is asked again, and after `tries` such traces `kernels`
    and `copies` are None (not measured) and only the count says the loop
    ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        before = sum(eps_loop_shapes().values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        loop_launches = sum(eps_loop_shapes().values()) - before
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
        if kernels:
            break
    else:
        kernels = copies = None
    return {"kernels": kernels, "copies": copies, "syncs": syncs - 1,  # less the closing one
            "loop_launches": loop_launches}


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
            rec["loop_event_ms"] = time_cuda(
                lambda: EPS.enqueue_components(b, n, device, pts, None, valid_u8, groups, eps2), reps
            )
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


def check_eps_packed(device, shapes=EPS_PACKED_SHAPES, count_calls=True):
    """`eps_components_packed`, the entry the tiers call, at shapes the main
    paths launch: the kernel's labels against the plain loop and against the
    host union-find on the same runs.  count_calls: also count one call's
    kernels, copies and synchronisations from a profiler trace."""
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
        # One look at every valid pair: the loop kernel skips rows that have
        # settled and column tiles too far away, so rounds x one sweep would
        # be more than it does.
        rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
        if device.type == "cuda":
            rec["driver_ms"] = median_ms(lambda: EPS.eps_components_packed(rows, eps2))
            rec["loop_event_ms"] = time_cuda(
                lambda: EPS.enqueue_components(b, n, device, None, rows, None, None, eps2), 10
            )
            if count_calls:
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


def seg_agreement(img, config, device_a, device_b) -> float:
    """Share of pixels whose segment ids agree between two devices' runs of
    the ROI + segment stages (same ids up to the segment numbering)."""
    import numpy as np

    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.models import codec, roi_fused
    from roibasedimagecompression_torch.ops import canny

    if config.fast_edges:
        lows, highs = canny.fast_thresholds_many(img[None], device_a)
        low, high = float(lows[0]), float(highs[0])
    else:
        low, high = canny.select_thresholds_pair(img)
    roi, nonroi = roi_fused.roi_masks_fast(img, config, low, high)
    regions = codec._extract_and_assign(img, roi, nonroi, config, cfg.min_region_size(img.size))
    a = codec.build_segment_map(img, *regions, config, device_a)[0]
    b = codec.build_segment_map(img, *regions, config, device_b)[0]
    return float(np.mean(a == b))


def eps_loop_shapes() -> dict:
    """(B, N) -> launches of the eps loop kernel in the launch record (the
    record's other `epscc` keys are the lone sweep's, ("sweep", B, N))."""
    from roibasedimagecompression_torch.ops.cuda import _build

    return {key: n for key, n in _build.launched["epscc"].items() if key[0] != "sweep"}


def reset_counts() -> None:
    """Clear the kernels' launch record and the program's counters: called
    just before a path runs."""
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.utils import timing

    timing.reset_stages()
    _build.reset_launches()


def read_counts():
    """(launch counts, launch-shape histograms) since reset_counts, read from
    the kernels' launch record and the program's counters."""
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.utils import timing

    rec = _build.launched
    sa = rec["slic_assign"]
    loop = eps_loop_shapes()
    launched_shapes["slic_assign"].update(sa)
    launched_shapes["eps_components"].update(loop)
    launched_shapes["gumbel"].update(rec["gumbel"])
    launched_shapes["kmeanspp"].update(rec["kmeanspp"])
    counters = timing.counters()

    def by_form(form):
        return sum(n for key, n in sa.items() if key[0] == form)

    launches = {"slic_assign": sa.total(), "slic_assign_expanded": by_form("expanded"),
                "slic_assign_direct": by_form("direct"), "eps_components": sum(loop.values()),
                "eps_sweep_alone": rec["epscc"].total() - sum(loop.values()),
                "eps_rounds": counters.get("eps_rounds", 0),
                "gumbel": rec["gumbel"].total(), "kmeanspp": rec["kmeanspp"].total(),
                "kmeans_seed.kernel": counters.get("kmeans_seed.kernel", 0),
                "kmeans_seed.loop": counters.get("kmeans_seed.loop", 0)}
    shapes = {
        "slic_assign (form, B, MP, K)": {str(k): v for k, v in sorted(sa.items())},
        "eps loop (B, N)": {str(k): v for k, v in sorted(loop.items())},
        "gumbel (seed, n_draws, m)": {str(k): v for k, v in sorted(rec["gumbel"].items())},
        "kmeanspp (B, m, n_draws, k_max)": {str(k): v for k, v in sorted(rec["kmeanspp"].items())},
    }
    return launches, shapes


def check_seedings(launches, what) -> None:
    """On an unweighted path every k-means++ seeding (`kmeans_seed.kernel`)
    is one launch of kernel 4 in the launch record, beside one noise draw of
    kernel 3, and none takes the plain loop."""
    check(launches["kmeanspp"] == launches["kmeans_seed.kernel"] == launches["gumbel"]
          and launches["kmeans_seed.loop"] == 0,
          f"{what} seeded k-means++ off the kernel: {launches}")


def compare_with_cpu(results, images, datas, refs, config, device) -> None:
    """Hold each card encode to the CPU encode of the same image: bytes equal,
    else segment maps >= 99.5 %, |dPSNR| <= 0.05 dB, |size| <= 1 % (a float
    argmin may flip at an exact tie)."""
    import torch

    import roibasedimagecompression_torch as rtt

    for i, (img, data, ref) in enumerate(zip(images, datas, refs)):
        r = results[i]
        r["bytes_equal_cpu"] = data == ref
        if data != ref:
            r["seg_agreement_cpu"] = seg_agreement(img, config, device, torch.device("cpu"))
            r["dpsnr_cpu"] = r["psnr_db"] - psnr(img, rtt.decode(ref))
            r["dbpp_rel_cpu"] = (len(data) - len(ref)) / len(ref)
            check(
                r["seg_agreement_cpu"] >= 0.995 and abs(r["dpsnr_cpu"]) <= 0.05
                and abs(r["dbpp_rel_cpu"]) <= 0.01,
                f"image {i}: CUDA encode departs from the CPU encode: {r}",
            )


def decode_and_score(images, datas, device, with_ssim=False) -> list:
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch.ops import metrics

    results = []
    for img, data in zip(images, datas):
        out = rtt.decode(data)
        check(out.shape == img.shape, f"decoded shape {out.shape} != {img.shape}")
        p = psnr(img, out)
        check(p > 28.0, f"PSNR {p:.2f} dB is below the 28 dB floor")
        r = {"psnr_db": p, "bpp": len(data) * 8 / (img.shape[0] * img.shape[1])}
        if with_ssim:
            r["ssim"] = float(metrics.ssim(torch.from_numpy(img).to(device),
                                           torch.from_numpy(out).to(device)))
            check(0.0 < r["ssim"] <= 1.0, f"SSIM {r['ssim']} is out of range")
        results.append(r)
    return results


def run_end_to_end(device, n_images=2, h=512, w=768, compare_cpu=True):
    """The one-image path: `encode` of each image in turn."""
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.utils import timing
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    images = [synthetic_image(100 + i, h, w) for i in range(n_images)]
    rtt.encode(images[0], device=device)  # warm-up: first-use builds, allocator
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    datas, secs = [], []
    for img in images:
        t0 = time.perf_counter()
        datas.append(rtt.encode(img, device=device))
        secs.append(time.perf_counter() - t0)
    launches, shapes = read_counts()
    stages = timing.stage_report()
    results = decode_and_score(images, datas, device)
    for r, s in zip(results, secs):
        r["seconds"] = s
    if compare_cpu and device.type == "cuda":
        refs = [rtt.encode(img, device="cpu") for img in images]
        compare_with_cpu(results, images, datas, refs, cfg.CodecConfig(), device)
    idle = device_idle_share(lambda: [rtt.encode(img, device=device) for img in images]) \
        if device.type == "cuda" else None
    return results, launches, shapes, stages, idle, images, datas


def check_pairs(device, images):
    """The device pair table on the tall map of `images` and their real
    segment maps, against the host runtime's pack, repair, paint and a host
    bincount: all exact.  Returns sizes and the stage times by CUDA events."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops import pairs as PAIRS
    from roibasedimagecompression_torch.parallel import stream as STREAM

    batch = np.stack(images)
    b, h, w, _ = batch.shape
    tall_seg, _, _, _, dbatch = STREAM._segment_stack(batch, cfg.CodecConfig(), device)
    check(dbatch is not None, "the segment stage left no batch on the device")
    tall_img = batch.reshape(b * h, w, 3)
    table = PAIRS.DevicePairTable(tall_seg, images_dev=dbatch.img)
    t0 = time.perf_counter()
    uniq, inverse, counts = native.pack_pairs(tall_img, tall_seg)
    host_pack_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(table.uniq, uniq), "DevicePairTable.uniq differs from native.pack_pairs")
    check(np.array_equal(table.counts, counts), "DevicePairTable.counts differs from native.pack_pairs")
    check(table.n_pairs == len(uniq) > 0, "the smoke's images gave no pairs")
    u, c = uniq.copy(), counts.copy()
    m, remap = native.black_repair_pairs(u, c, None, return_remap=True)
    u2, c2 = uniq.copy(), counts.copy()
    check(native.black_repair_pairs(u2, c2, inverse) == m, "the two black repairs disagree")
    host_colors = native.split_pair_uniq(u[:m])[2].astype(np.uint8)
    check(np.array_equal(table.colors_dev[:m].cpu().numpy(), host_colors),
          "colors_dev differs from the host post-repair colors")
    mask = tall_seg > 0
    rng = np.random.default_rng(0)
    rec = {"n_pix": int(tall_seg.size), "n_masked": int(mask.sum()), "n_pairs": int(table.n_pairs),
           "n_pairs_repaired": int(m), "host_pack_ms": host_pack_ms}
    for n_idx, k_pad in ((200, 256), (3000, 4096)):  # uint8 and uint16 index maps
        idx_of_pair = rng.integers(0, n_idx, m).astype(np.int32)
        flat, sums = table.paint(idx_of_pair, remap, refit_bins=(b, h * w, k_pad))
        host_map = np.zeros((b * h, w), flat.dtype)
        native.paint_masked_indices(idx_of_pair, inverse, mask, host_map)
        check(np.array_equal(flat, host_map.reshape(-1)),
              f"paint() differs from the host paint_masked_indices map ({n_idx} indices)")
        bins = ((np.arange(b * h * w) // (h * w)) * k_pad + host_map.reshape(-1))[mask.reshape(-1)]
        pix = tall_img.reshape(-1, 3)[mask.reshape(-1)].astype(np.float64)
        for ch, col in enumerate([np.ones(len(pix)), pix[:, 0], pix[:, 1], pix[:, 2]]):
            host = np.bincount(bins, weights=col, minlength=b * k_pad).astype(np.int64)
            check(np.array_equal(sums[:, ch], host), f"refit rows differ from a host bincount ({n_idx} indices)")
    if device.type == "cuda":
        seg_flat = torch.from_numpy(tall_seg.reshape(-1)).to(device)
        rgb_flat = dbatch.img.reshape(-1, 3)
        key_s, perm, new, pair_id, n_pairs, n_valid = PAIRS._pair_sort(seg_flat, rgb_flat)
        cap = PAIRS._pow2(n_pairs, minimum=4096)
        idx_dev = torch.from_numpy(idx_of_pair[remap]).to(device)
        rec["sort_ms"] = time_cuda(lambda: PAIRS._pair_sort(seg_flat, rgb_flat), 5, 1)
        rec["compact_ms"] = time_cuda(
            lambda: PAIRS._pair_compact(key_s, new, pair_id, n_valid, n_pairs, cap=cap), 5, 1)
        rec["paint_ms"] = time_cuda(
            lambda: PAIRS._paint_indices(perm, pair_id, n_valid, idx_dev, torch.int32), 5, 1)
        rec["refit_ms"] = time_cuda(
            lambda: PAIRS._refit_sums(perm, pair_id, key_s, n_valid, idx_dev, k_pad=k_pad, hw=h * w, b=b), 5, 1)
    return rec


def run_batch(device, images, config, compare_cpu=True, profile=True, n_cpu=2):
    """The batch path: one warm `encode_many`, the counts read around it.
    The first `n_cpu` images are held to the CPU `encode_many` of those
    images (an image's bytes do not depend on the rest of its batch, and a
    CPU encode of 8 such images takes minutes)."""
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import timing

    STREAM.encode_many(images, config, device)  # warm-up: this batch's shapes
    reset_counts()
    t0 = time.perf_counter()
    datas = STREAM.encode_many(images, config, device)
    seconds = time.perf_counter() - t0
    launches, shapes = read_counts()
    stages = timing.stage_report()
    results = decode_and_score(images, datas, device, with_ssim=True)
    os.environ["RHCCQ_DEVICE_PAIRS"] = "0"
    try:
        host_pack = STREAM.encode_many(images, config, device)
    finally:
        del os.environ["RHCCQ_DEVICE_PAIRS"]
    check(host_pack == datas, "encode_many with RHCCQ_DEVICE_PAIRS=0 wrote other bytes")
    if compare_cpu and device.type == "cuda":
        refs = STREAM.encode_many(images[:n_cpu], config, "cpu")
        compare_with_cpu(results, images[:n_cpu], datas, refs, config, device)
    idle = device_idle_share(lambda: STREAM.encode_many(images, config, device)) \
        if profile and device.type == "cuda" else None
    return {"seconds": seconds, "images_per_second": len(images) / seconds, "results": results,
            "launches": launches, "shapes": shapes, "stages": stages, "idle": idle, "datas": datas}


def run_with_deadline(fn, seconds: float, what: str):
    """Run `fn` on a thread and return its result; if it has not ended after
    `seconds` (two cooperative launches waiting on each other would never
    end), say so and end the process: a thread stuck inside a CUDA call cannot
    be stopped from here."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:  # re-raised on the caller's thread
            box["error"] = exc

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        print(f"chip_smoke: FAILED: {what} did not end within {seconds:.0f} s", file=sys.stderr, flush=True)
        os._exit(1)
    if "error" in box:
        raise box["error"]
    return box["value"]


def run_stream(device, batches, first_batch_datas, deadline=300.0):
    """`encode_stream` with two workers against sequential `encode_many`."""
    from roibasedimagecompression_torch.parallel import stream as STREAM

    t0 = time.perf_counter()
    seq = [STREAM.encode_many(bt, None, device) for bt in batches]
    seq_seconds = time.perf_counter() - t0
    check(seq[0] == first_batch_datas, "a second encode_many of the same batch wrote other bytes")
    reset_counts()
    t0 = time.perf_counter()
    got = run_with_deadline(lambda: STREAM.encode_stream(batches, None, 2, device), deadline,
                            "encode_stream(workers=2)")
    seconds = time.perf_counter() - t0
    launches, shapes = read_counts()
    check(got == seq, "encode_stream(workers=2) differs from sequential encode_many")
    n = sum(len(bt) for bt in batches)
    return {"seconds": seconds, "images_per_second": n / seconds, "sequential_seconds": seq_seconds,
            "sequential_images_per_second": n / seq_seconds, "launches": launches, "shapes": shapes,
            "datas": seq}


CLI_OPTIONS = (("mediancut", ["--split-method", "mediancut"]),
               ("kmeans-mc", ["--split-method", "kmeans-mc"]),
               ("enhance-shadows", ["--enhance-shadows"]),
               ("container-level-7", ["--container-level", "7"]))


def cli_main(argv) -> tuple:
    """`__main__.main(argv)` in this process: (return code, its standard
    output, seconds)."""
    from roibasedimagecompression_torch import __main__ as CLI

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_config(extra):
    """The CodecConfig the CLI builds for `extra` on top of its defaults."""
    from roibasedimagecompression_torch import config as cfg

    kw = {"split_margin": 2.0}
    if "--split-method" in extra:
        kw["split_method"] = extra[extra.index("--split-method") + 1]
    if "--container-level" in extra:
        kw["container_level"] = int(extra[extra.index("--container-level") + 1])
    return cfg.CodecConfig(**kw)


def run_cli(device, images, datas, compare_cpu=True):
    """The command line over `images` (phase 5's), in the layout `sweep`
    reads.  Returns per-subcommand seconds, the in-process encodes' launch
    counts and shapes (each option read around its own run) and their
    stage seconds."""
    import numpy as np

    from roibasedimagecompression_torch.io import container, image_io
    from roibasedimagecompression_torch.models.enhance import enhance_shadows
    from roibasedimagecompression_torch.ops import metrics
    from roibasedimagecompression_torch.utils import timing

    out = {"seconds": {}, "options": {}}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "png"))
        os.makedirs(os.path.join(root, "rhccq_20_10"))
        pngs = [os.path.join(root, "png", f"{i + 1}.png") for i in range(len(images))]
        rqs = [os.path.join(root, "rhccq_20_10", f"compressed_{i + 1}.rhccq") for i in range(len(images))]
        for path, img in zip(pngs, images):
            image_io.imwrite(path, img)
        # The real entry point once: at CodecConfig()'s split margin (the CLI's
        # default is 2.0), so it writes phase 5's bytes.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "roibasedimagecompression_torch", "encode", pngs[0], rqs[0],
             "--split-margin", "1.5", "--device", device.type],
            capture_output=True, text=True, timeout=600, cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", "")),
        )
        out["seconds"]["encode (python3 -m, a new process)"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"python3 -m ... encode exited {proc.returncode}: {proc.stderr[-2000:]}")
        out["subprocess_line"] = proc.stdout.strip()
        with open(rqs[0], "rb") as f:
            check(f.read() == datas[0], "the CLI encode (python3 -m) differs from encode() of the same image")

        # In process, at the CLI's defaults and with each option, counts read
        # around each; each held to the same command with --device cpu.
        for label, extra in (("defaults", []),) + CLI_OPTIONS:
            target = rqs[1] if label == "defaults" else os.path.join(root, f"{label}.rhccq")
            argv = ["encode", pngs[1], target, *extra, "--device", device.type]
            cli_main(argv)  # warm-up: this option's first-use costs
            reset_counts()
            rc, line, secs = cli_main(argv)
            launches, shapes = read_counts()
            stages = timing.stage_report()
            check(rc is None, f"encode {extra} returned {rc}")
            for name in ("slic_assign", "eps_components"):
                check(device.type != "cuda" or launches[name] > 0,
                      f"the CLI encode {extra} launched {name} no time")
            rec = {"seconds": secs, "line": line.strip(), "launches": launches, "shapes": shapes,
                   "stages": {k: v["seconds"] for k, v in stages.items()}}
            with open(target, "rb") as f:
                data = rec["data"] = f.read()
            img = images[1]
            if "--enhance-shadows" in extra:
                img = enhance_shadows(img, device=device)
            rec["psnr_db"] = psnr(img, container.unpack(data).to_rgb())
            check(rec["psnr_db"] > 28.0, f"CLI encode {extra}: PSNR {rec['psnr_db']:.2f} dB is below 28 dB")
            if compare_cpu and device.type == "cuda":
                ref_path = os.path.join(root, f"{label}.cpu.rhccq")
                t0 = time.perf_counter()
                check(cli_main(["encode", pngs[1], ref_path, *extra, "--device", "cpu"])[0] is None,
                      f"encode {extra} --device cpu failed")
                rec["cpu_seconds"] = time.perf_counter() - t0
                with open(ref_path, "rb") as f:
                    ref = f.read()
                r = [{"psnr_db": rec["psnr_db"]}]
                compare_with_cpu(r, [img], [data], [ref], cli_config(extra), device)
                rec.update(r[0])
            out["options"][label] = rec
            out["seconds"][f"encode {' '.join(extra) or '(defaults)'}"] = secs

        # Decode and score.
        rc, _, out["seconds"]["decode"] = cli_main(["decode", rqs[1], os.path.join(root, "d.png")])
        check(rc is None, "decode failed")
        decoded = image_io.imread_rgb(os.path.join(root, "d.png"))
        check(np.array_equal(decoded, container.decode_file(rqs[1])), "decode wrote other pixels")
        want = metrics.quality_metrics(images[1], decoded, device)
        for flag in ([], ["--adaptive"]):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, text, secs = cli_main(["eval", pngs[1], rqs[1], *flag, "--device", device.type])
            out["seconds"][f"eval {' '.join(flag)}".strip()] = secs
            got = json.loads(text)
            check(rc is None and got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"],
                  f"eval {flag} printed psnr {got['psnr']}, ssim {got['ssim']}; quality_metrics gives {want}")
            check(got["psnr"] > 28.0, f"eval PSNR {got['psnr']:.2f} dB is below 28 dB")
            if flag:
                check("adaptive" in got and "OUTLIER DETECTION" in err.getvalue(), "eval --adaptive printed no report")
        out["eval"] = got
        csv_path = os.path.join(root, "sweep.csv")
        rc, text, out["seconds"]["sweep"] = cli_main(["sweep", root, "--csv", csv_path, "--device", device.type])
        with open(csv_path) as f:
            rows = f.read().splitlines()
        check(rc is None and len(rows) == 1 + len(images), f"sweep wrote {len(rows) - 1} CSV rows")
        out["sweep_summary"] = " | ".join(text.strip().splitlines()[3:5])
        try:
            import PIL  # noqa: F401  (JPEG needs Pillow)
        except ImportError:
            out["compare"] = "skipped: Pillow is not installed"
        else:
            from roibasedimagecompression_torch.eval import report

            jpg = os.path.join(root, "base.jpg")
            report.compress_with_jpeg(pngs[1], jpg, quality=85)
            rc, text, out["seconds"]["compare --jpeg"] = cli_main(
                ["compare", pngs[1], rqs[1], "--jpeg", jpg, "--device", device.type])
            row = json.loads(text)
            check(rc is None and row["rhccq"]["psnr"] == want["psnr"], "compare printed another PSNR")
            out["compare"] = {k: row[k] for k in ("delta_psnr", "delta_ssim", "delta_bpp")}
    return out


def run_canvas(device, images, datas, batch, batch_datas, n_cpu=1):
    """The canvas tiers path: `encode` of `images` and `encode_many` of
    `batch` under RHCCQ_CANVAS_TIERS=1 (their bytes must equal the composed
    path's, `datas` and `batch_datas`), then both at fill_black_holes=10 with
    the first `n_cpu` images held to the CPU encode; then one `encode` under
    RHCCQ_SLIC_PALLAS=1 against the CPU.  Counts and stage seconds are read
    around each run."""
    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import timing

    def counted(label, fn):
        reset_counts()
        t0 = time.perf_counter()
        value = fn()
        seconds = time.perf_counter() - t0
        launches, shapes = read_counts()
        for name in ("slic_assign", "eps_components"):
            check(device.type != "cuda" or launches[name] > 0, f"the canvas run {label} launched {name} no time")
        runs[label] = {"seconds": seconds, "launches": launches, "shapes": shapes,
                       "stages": {k: v["seconds"] for k, v in timing.stage_report().items()}}
        return value

    runs = {}
    fill = cfg.CodecConfig(fill_black_holes=10)
    os.environ["RHCCQ_CANVAS_TIERS"] = "1"
    try:
        got_one = counted("encode, RHCCQ_CANVAS_TIERS=1", lambda: [rtt.encode(im, device=device) for im in images])
        check(got_one == datas, "encode under RHCCQ_CANVAS_TIERS=1 differs from the composed path")
        got = counted("encode_many, RHCCQ_CANVAS_TIERS=1", lambda: STREAM.encode_many(batch, None, device))
        check(got == batch_datas, "encode_many under RHCCQ_CANVAS_TIERS=1 differs from the composed path")
    finally:
        del os.environ["RHCCQ_CANVAS_TIERS"]
    filled = counted("encode, fill_black_holes=10",
                     lambda: [rtt.encode(im, fill, device=device) for im in images])
    filled_many = counted("encode_many, fill_black_holes=10", lambda: STREAM.encode_many(batch, fill, device))
    # `images` are the first images of `batch` (seeds 100 and 101).
    check(filled_many[: len(images)] == filled, "encode_many and encode disagree at fill_black_holes=10")
    results = decode_and_score(images, filled, device) + decode_and_score(batch, filled_many, device)
    if device.type == "cuda":
        refs = [rtt.encode(im, fill, device="cpu") for im in images[:n_cpu]]
        compare_with_cpu(results, images[:n_cpu], filled, refs, fill, device)
    os.environ["RHCCQ_SLIC_PALLAS"] = "1"
    try:
        direct = counted("encode, RHCCQ_SLIC_PALLAS=1", lambda: rtt.encode(images[0], device=device))
        check(device.type != "cuda" or runs["encode, RHCCQ_SLIC_PALLAS=1"]["launches"]["slic_assign_direct"] > 0,
              "the encode under RHCCQ_SLIC_PALLAS=1 did not launch kernel 1's direct form")
        if device.type == "cuda":
            ref = rtt.encode(images[0], device="cpu")
            r = [{"psnr_db": psnr(images[0], rtt.decode(direct))}]
            compare_with_cpu(r, images[:1], [direct], [ref], cfg.CodecConfig(), device)
            runs["encode, RHCCQ_SLIC_PALLAS=1"]["bytes_equal_cpu"] = r[0]["bytes_equal_cpu"]
    finally:
        del os.environ["RHCCQ_SLIC_PALLAS"]
    return {"runs": runs, "results": results,
            "datas": {"canvas encode": got_one, "canvas encode_many": got, "fill encode": filled,
                      "fill encode_many": filled_many, "pallas encode": [direct]}}


def run_loop(device, image, n_cpu=1):
    """The reference-shaped loop on `image`: `encode` at
    CodecConfig(batched=False, single_region=True) and CodecConfig(batched=
    False), counts and stage seconds read around each, bytes held to the CPU
    encode (the first `n_cpu` configs); then the ROI masks' box filter on the
    card against the CPU, bit for bit, on the image's edge map."""
    import numpy as np
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.ops import canny
    from roibasedimagecompression_torch.ops import conv
    from roibasedimagecompression_torch.utils import timing

    runs = {}
    configs = (("single_region", cfg.CodecConfig(batched=False, single_region=True)),
               ("roi", cfg.CodecConfig(batched=False)))
    for i, (label, config) in enumerate(configs):
        reset_counts()
        t0 = time.perf_counter()
        data = rtt.encode(image, config, device=device)
        seconds = time.perf_counter() - t0
        launches, shapes = read_counts()
        for name in ("slic_assign", "eps_components"):
            check(device.type != "cuda" or launches[name] > 0, f"the loop ({label}) launched {name} no time")
        rec = decode_and_score([image], [data], device)[0]
        rec.update({"seconds": seconds, "launches": launches, "shapes": shapes, "data": data,
                    "stages": {k: v["seconds"] for k, v in timing.stage_report().items()}})
        if i < n_cpu or device.type == "cuda":
            t0 = time.perf_counter()
            ref = rtt.encode(image, config, device="cpu")
            rec["cpu_seconds"] = time.perf_counter() - t0
            check(data == ref, f"the loop ({label}) on {device} wrote other bytes than on the CPU")
            rec["bytes_equal_cpu"] = True
        runs[label] = rec
    edges = torch.from_numpy(canny.get_edge_map(image)[0])
    box = {}
    for k in (3, 15, 25):
        got = conv.box_density(edges.to(device), k).cpu().numpy()
        want = conv.box_density(edges, k).numpy()
        check(bool((got.view(np.uint32) == want.view(np.uint32)).all()),
              f"box_density(k={k}) on {device} differs from the CPU's bits")
        box[k] = time_cuda(lambda: conv.box_density(edges.to(device), k), reps=3, warmup=1) \
            if device.type == "cuda" else None
    return {"runs": runs, "box_ms": box}


def run_options(device, image):
    """Region fusion and the weighted split (ROADMAP A12c) and
    `encode_debug` on `image`: `encode` at region_fusion=True and at
    weighted_split=True, the loop at both, counts and stage seconds read
    around each card run, each byte for byte equal to the CPU encode; then
    `encode_debug` on the card against the CPU, every intermediate equal."""
    import numpy as np

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.models import codec
    from roibasedimagecompression_torch.utils import timing

    runs = {}
    configs = (("encode, region_fusion=True", cfg.CodecConfig(region_fusion=True)),
               ("encode, weighted_split=True", cfg.CodecConfig(weighted_split=True)),
               ("loop, region_fusion=True, weighted_split=True",
                cfg.CodecConfig(batched=False, region_fusion=True, weighted_split=True)))
    for label, config in configs:
        reset_counts()
        t0 = time.perf_counter()
        data = rtt.encode(image, config, device=device)
        seconds = time.perf_counter() - t0
        launches, shapes = read_counts()
        for name in ("slic_assign", "eps_components"):
            check(device.type != "cuda" or launches[name] > 0, f"{label} launched {name} no time")
        rec = decode_and_score([image], [data], device)[0]
        rec.update({"seconds": seconds, "launches": launches, "shapes": shapes, "data": data,
                    "stages": {k: v["seconds"] for k, v in timing.stage_report().items()}})
        t0 = time.perf_counter()
        ref = rtt.encode(image, config, device="cpu")
        rec["cpu_seconds"] = time.perf_counter() - t0
        check(data == ref, f"{label} on {device} wrote other bytes than on the CPU")
        runs[label] = rec
    reset_counts()
    t0 = time.perf_counter()
    dbg = codec.encode_debug(image, device=device)
    seconds = time.perf_counter() - t0
    launches, shapes = read_counts()
    t0 = time.perf_counter()
    ref = codec.encode_debug(image, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    for key, want in ref.items():
        got = dbg[key]
        same = got == want if key == "data" else bool(np.array_equal(got, want))
        check(same, f"encode_debug's {key} on {device} differs from the CPU's")
    rec = decode_and_score([image], [dbg["data"]], device)[0]
    rec.update({"seconds": seconds, "cpu_seconds": cpu_seconds, "launches": launches, "shapes": shapes,
                "roi_share": float(np.mean(dbg["roi_mask"]))})
    runs["encode_debug"] = rec
    return runs


def nonative_child(out_path: str) -> int:
    """The `--nonative-child` process of phase 12: RHCCQ_NATIVE=0 is in its
    environment (the switch is read once per process).  Runs `encode` of the
    first 768x512 image, `encode_many` of the first two of the batch and the
    loop on the first image, each on the card with counts, stage seconds and
    connected-components passes read around it and its payload digest, the
    first and the last byte for byte equal to the same call on the CPU (the
    batch is held by phase 15 against the JAX package); then `encode` of the
    batch's third image (seed 102) for the parity phase, held by its digest
    only; then times the propagation on the card per pass.  Writes a JSON
    record to `out_path`."""
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.io import container
    from roibasedimagecompression_torch.ops import canny
    from roibasedimagecompression_torch.ops import cc as CC
    from roibasedimagecompression_torch.ops import colors
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import timing
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    check(not native.available(), "RHCCQ_NATIVE=0 did not switch the runtime off")
    device = torch.device("cuda")
    images = [synthetic_image(100 + i, 512, 768) for i in range(3)]
    loop = cfg.CodecConfig(batched=False)
    runs = {}
    for label, card, cpu in (
        ("encode", lambda: rtt.encode(images[0], device=device),
         lambda: rtt.encode(images[0], device="cpu")),
        # Held by phase 15 against the JAX package's digests: its CPU run
        # (1.5 minutes on the card's host) is left out.
        ("encode_many of 2", lambda: STREAM.encode_many(images[:2], None, device), None),
        ("loop", lambda: rtt.encode(images[0], loop, device=device),
         lambda: rtt.encode(images[0], loop, device="cpu")),
    ):
        reset_counts()
        CC.PASSES[0] = 0
        t0 = time.perf_counter()
        data = card()
        seconds = time.perf_counter() - t0
        launches, shapes = read_counts()
        passes = CC.PASSES[0]
        stages = {k: round(v["seconds"], 4) for k, v in timing.stage_report().items()}
        for name in ("slic_assign", "eps_components"):
            check(launches[name] > 0, f"the run without the runtime ({label}) launched {name} no time")
        cpu_seconds = None
        if cpu is not None:
            t0 = time.perf_counter()
            ref = cpu()
            cpu_seconds = time.perf_counter() - t0
            check(data == ref, f"without the runtime, {label} on the card wrote other bytes than on the CPU")
        datas = data if isinstance(data, list) else [data]
        rec = decode_and_score(images[: len(datas)], datas, device)
        runs[label] = {"seconds": seconds, "cpu_seconds": cpu_seconds, "launches": launches,
                       "shapes": shapes, "cc_passes": passes, "stages": stages,
                       "psnr_db": [r["psnr_db"] for r in rec], "bpp": [r["bpp"] for r in rec],
                       "digests": [container.payload_digest(d) for d in datas]}
    # The parity phase's run without the runtime: seed 102 (ROI pixels),
    # held by its digest only (no CPU run).
    reset_counts()
    t0 = time.perf_counter()
    data = rtt.encode(images[2], device=device)
    parity = {"seconds": time.perf_counter() - t0, "launches": read_counts()[0],
              "digest": container.payload_digest(data),
              "psnr_db": decode_and_score(images[2:], [data], device)[0]["psnr_db"]}
    # The propagation's card time per pass: the first image's weak Canny
    # graph (one map), and the 20 candidates' graphs of its gray image at
    # once, as the threshold scoring runs them.
    img = torch.from_numpy(images[0]).to(device)
    low, high = canny.select_thresholds_pair(images[0], device)
    mag, nms = canny.gradient_and_nms(img, rgb=True)
    gray = colors.rgb_to_gray_cv2(img)
    gmag, gnms = canny.gradient_and_nms(gray, rgb=False)
    cands = canny.adaptive_thresholds(gray)
    per_pass = {}
    for label, weak in (("weak graph, 512x768", nms & (mag > low)),
                        ("20 candidates, 20x512x768", gnms[None] & (gmag[None] > cands[:, 0, None, None]))):
        CC.PASSES[0] = 0
        CC.propagate_labels(weak)
        passes = CC.PASSES[0]
        ms = time_cuda(lambda: CC.propagate_labels(weak), reps=3, warmup=1)
        per_pass[label] = {"passes": passes, "ms": ms, "ms_per_pass": ms / passes}
    with open(out_path, "w") as f:
        json.dump({"runs": runs, "cc": per_pass, "thresholds": [low, high], "parity": parity,
                   "launched_shapes": {k: sorted(v) for k, v in launched_shapes.items()}}, f)
    return 0


def run_nonative(deadline: float = 900.0) -> dict:
    """Phase 12: `nonative_child` in a new process under RHCCQ_NATIVE=0; the
    shapes it launched join the cover phase."""
    fd, out_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--nonative-child", out_path],
            env=dict(os.environ, RHCCQ_NATIVE="0"), capture_output=True, text=True,
            timeout=deadline, cwd=HERE,
        )
        for line in proc.stdout.splitlines():
            print(f"[nonative child] {line}")
        check(proc.returncode == 0, f"the run without the runtime failed:\n{proc.stderr[-3000:]}")
        with open(out_path) as f:
            rec = json.load(f)
    finally:
        os.unlink(out_path)
    for name, shapes in rec["launched_shapes"].items():
        launched_shapes[name].update(tuple(s) for s in shapes)
    return rec


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------

PARITY_DATA = os.path.join(HERE, "tests", "data", "jax_parity_768x512.json")
# Rows of the data file that ROADMAP §C keeps open (row id -> §C item): an
# open row is printed and not failed.  None is open.
PARITY_OPEN: dict = {}
# The CLI's default split margin; CodecConfig()'s is 1.5 (rows h*).
CLI_MARGIN = {"split_margin": 2.0}


def run_parity(device, held: list, image102, nonative_parity: dict) -> dict:
    """Phase 15: the card's 768x512 encodes against the JAX package's
    answers in PARITY_DATA (written by the JAX package on the CPU; no JAX
    here).  `held`: (row, seeds, card bytes, equal to the port's CPU bytes:
    True, False where that phase took its allowance, None where it made no
    CPU run) of the encodes phases 5, 7 and 9-12 made.  A digest must equal
    the file's, except after an allowance, where PSNR is held to the file's
    within 0.05 dB.  Then the seed-102 encodes of rows d, e, f, g and h on
    the card, held by their digests only, counts read around each (row j's
    is `nonative_parity`, from phase 12's child).  Row b's decodes are also
    scored on the card: PSNR and SSIM to the file's 7 decimals."""
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.io import container
    from roibasedimagecompression_torch.models.enhance import enhance_shadows
    from roibasedimagecompression_torch.ops import metrics
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    with open(PARITY_DATA) as f:
        doc = json.load(f)
    entries = {(e["row"], e["seed"]): e for e in doc["entries"]}
    rows, launches = [], {}

    def hold(row, seed, data, equal_cpu, source, seconds=None):
        """`data`: the card's bytes, or (phase 12's child) their digest."""
        e = entries[(row, seed)]
        digest = data if isinstance(data, str) else container.payload_digest(data)
        rec = {"row": row, "seed": seed, "source": source, "roi_pixels": e["port_roi_pixels"],
               "digest_equal": digest == e["digest"]}
        if seconds is not None:
            rec["seconds"] = seconds
        if not rec["digest_equal"] and not isinstance(data, str):
            img = synthetic_image(seed, 512, 768)
            if e["enhance"]:
                img = enhance_shadows(img, device=device)
            rec["psnr_db"] = psnr(img, rtt.decode(data))
            rec["dpsnr_jax"] = rec["psnr_db"] - e["psnr"]
        rows.append(rec)
        label = f"[parity] row {row}, seed {seed} ({source})"
        if row in PARITY_OPEN:
            print(f"{label}: open ({PARITY_OPEN[row]}): {json.dumps(rec)}")
        elif equal_cpu is False and "dpsnr_jax" in rec:
            check(abs(rec["dpsnr_jax"]) <= 0.05,
                  f"{label}: the card's PSNR departs from the JAX package's: {rec}")
            print(f"{label}: after the allowance to the CPU: {json.dumps(rec)}")
        else:
            check(rec["digest_equal"], f"{label}: the payload digest differs from the JAX package's: {rec}")

    for row, seeds, datas, equal, source in held:
        for seed, data, eq in zip(seeds, datas, equal):
            hold(row, seed, data, eq, source)
    # Row b's decodes, scored on the card: the jitted quality_metrics' PSNR
    # and SSIM, to the file's 7 decimals.
    _, b_seeds, b_datas, _, _ = next(h for h in held if h[0] == "b")
    for seed, data in zip(b_seeds, b_datas):
        q = metrics.quality_metrics(synthetic_image(seed, 512, 768), rtt.decode(data), device)
        want = entries[("b", seed)]
        check(round(q["psnr"], 7) == want["psnr"] and round(q["ssim"], 7) == want["ssim"],
              f"row b seed {seed}: PSNR {q['psnr']}, SSIM {q['ssim']} on the card; the file has {want}")

    new = (("d", cfg.CodecConfig(), {"RHCCQ_SLIC_PALLAS": "1"}, False),
           ("e1", cfg.CodecConfig(batched=False), {}, False),
           ("e2", cfg.CodecConfig(batched=False, single_region=True), {}, False),
           ("f1", cfg.CodecConfig(region_fusion=True), {}, False),
           ("f2", cfg.CodecConfig(weighted_split=True), {}, False),
           ("f3", cfg.CodecConfig(batched=False, region_fusion=True, weighted_split=True), {}, False),
           ("g", cfg.CodecConfig(weighted_split=True, split_method="kmeans"), {}, False),
           ("h1", cfg.CodecConfig(split_method="mediancut", **CLI_MARGIN), {}, False),
           ("h2", cfg.CodecConfig(split_method="kmeans-mc", **CLI_MARGIN), {}, False),
           ("h3", cfg.CodecConfig(**CLI_MARGIN), {}, True))
    for row, config, env, enhance in new:
        img = enhance_shadows(image102, device=device) if enhance else image102
        os.environ.update(env)
        try:
            reset_counts()
            t0 = time.perf_counter()
            data = rtt.encode(img, config, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()[0]
        finally:
            for k in env:
                del os.environ[k]
        for name in ("slic_assign", "eps_components"):
            check(device.type != "cuda" or counts[name] > 0, f"the parity run of row {row} launched {name} no time")
        launches[row] = counts
        hold(row, 102, data, None, "a new card encode", seconds)
    launches["j1"] = nonative_parity["launches"]
    e = entries[("j1", 102)]
    rec = {"row": "j1", "seed": 102, "source": "a new card encode under RHCCQ_NATIVE=0",
           "roi_pixels": e["port_roi_pixels"], "seconds": nonative_parity["seconds"],
           "digest_equal": nonative_parity["digest"] == e["digest"]}
    rows.append(rec)
    check(rec["digest_equal"] or "j1" in PARITY_OPEN,
          f"[parity] row j1, seed 102: the payload digest differs from the JAX package's: {rec}")
    totals = {name: sum(c[name] for c in launches.values()) for name in next(iter(launches.values()))}
    return {"rows": rows, "launches": launches, "launch_totals": totals, "ssim_checked": len(b_seeds)}


def device_idle_share(fn) -> dict:
    """Run `fn` inside one profiler window and return the window's length on
    the host clock, the time in which at least one kernel or copy ran on the
    card (union of their intervals), and the share in which none did.  Where
    the trace holds none of the card's activity, the busy time and the share
    are None (not measured): the kernels' launch counts, not this window,
    show that the path ran on the card."""
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
    if not spans:
        return {"window_ms": window_us / 1e3, "busy_ms": None, "device_events": 0, "idle_share": None}
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3, "device_events": len(spans),
            "idle_share": 1.0 - busy_us / window_us}


def timed(fn, device):
    """(result, host seconds) of `fn`, synchronised on the card."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_side(device, image, refs) -> dict:
    """Phase 13: the side modules on the card against the CPU; the CPU calls
    run on `refs`' thread meanwhile."""
    import numpy as np
    import torch

    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.models import codec, roi_extras, roi_fused, spline, spline_viz
    from roibasedimagecompression_torch.ops import bilateral, canny, contours, thinning

    cpu = torch.device("cpu")
    config = cfg.CodecConfig()
    low, high = canny.select_thresholds_pair(image)
    roi, nonroi = roi_fused.roi_masks_fast(image, config, low, high)
    out = {"roi_pixels": int(roi.sum())}
    check(out["roi_pixels"] >= 1000, f"the image's ROI mask has {out['roi_pixels']} pixels: nothing to test on")

    calls = {
        "thinning": lambda d: thinning.zhang_suen_thinning(torch.from_numpy(roi).to(d)).cpu().numpy(),
        "remove_thin_structures_v1": lambda d: roi_extras.remove_thin_structures_v1(
            roi, thinness_threshold=0.3, device=d),
        "watershed": lambda d: roi_extras.watershed_segments(image, roi, 100, device=d),
        "bilateral": lambda d: bilateral.bilateral_filter(
            torch.from_numpy(image).to(d), 9, 75.0, 75.0).cpu().numpy(),
    }
    for method in ("dilation", "closing", "skeleton", "region_growing", "voronoi"):
        mask = roi[::8, ::8] if method == "voronoi" else roi
        calls[f"connect {method}"] = lambda d, m=mask, me=method: roi_extras.connect_nearby_pixels(
            m, connection_distance=3, method=me, min_region_size=5, device=d)
    wanted = {label: refs.submit(fn, cpu) for label, fn in calls.items()}

    def bilateral_rule(a, b):
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        out["bilateral_diff"] = {"pixels": int((diff.max(axis=-1) > 0).sum()), "max": int(diff.max())}
        return diff.max() <= 1 and (diff.max(axis=-1) > 0).mean() <= 0.001

    for label, fn in calls.items():
        fn(device)  # first call: allocations, kernel loads
        card, secs = timed(lambda: fn(device), device)
        equal = bilateral_rule if label == "bilateral" else np.array_equal
        check(equal(card, wanted[label].result()), f"side module {label}: the card differs from the CPU")
        out[label] = {"seconds": secs}
        if label == "watershed":
            out[label]["segments"] = int(len(np.unique(card[roi])))

    regions = codec._extract_and_assign(image, roi, nonroi, config, cfg.min_region_size(image.size))
    seg_map = codec.build_segment_map(image, *regions, config, device)[0]
    t0 = time.perf_counter()
    bounds = contours.segment_boundaries(seg_map, seg_map > 0)
    longest = max(bounds, key=lambda d: d["num_points"])
    coords = np.asarray(longest["boundary_coords"])
    result = spline.compress_shape(coords, num_sublists=3, compression_ratio=0.2)
    keys = spline.minimal_storage(result)
    recon = spline.reconstruct_from_minimal(keys, num_points=len(coords))
    quality = spline_viz.quality_metrics(coords, recon)
    check(recon.shape == coords.shape and np.isfinite(recon).all() and np.isfinite(quality["mean_error"]),
          f"spline reconstruction of the longest boundary failed: {quality}")
    out["spline"] = {"host_seconds": time.perf_counter() - t0, "segments": len(bounds),
                     "boundary_points": longest["num_points"], "key_points": len(keys),
                     "mean_error": result["overall_metrics"]["mean_error"], "quality": quality,
                     "analysis": spline_viz.compression_analysis(result).splitlines()[:5]}
    return out


def run_entry_surface(device, batches, stream_datas, refs) -> dict:
    """Phase 14: the entry surface on the card; `stream_datas` are phase 8's
    encode_many bytes of `batches` without a mesh; the CPU references run on
    `refs`' thread meanwhile."""
    import numpy as np
    import torch

    import roibasedimagecompression_torch as rtt
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch import entry
    from roibasedimagecompression_torch.models import pipeline_jit as PJ
    from roibasedimagecompression_torch.parallel import mesh as M
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import cachekey, flops, profiling, warmup

    cpu = torch.device("cpu")
    batch, batch_datas = batches[0], stream_datas[0]
    out = {"launches": {}, "shapes": {}}
    totals = None

    def add_counts(label):
        nonlocal totals
        launches, shapes = read_counts()
        out["launches"][label], out["shapes"][label] = launches, shapes
        totals = launches if totals is None else {k: totals[k] + launches[k] for k in totals}
        return launches

    def equal_outputs(a, b, what):
        for k in PJ.OUTPUTS:
            check(a[k].shape == b[k].shape and torch.equal(a[k].cpu(), b[k].cpu()),
                  f"{what}: output {k} differs")

    fn, args = entry.entry()
    kw = {"n_centers_side": 8, "palette_cap": 4096, "quality": 20.0}
    entry_ref = refs.submit(fn, *args, device=cpu)
    analysis_ref = refs.submit(lambda: timed(lambda: PJ.analysis_step(batch[0], device=cpu, **kw), cpu))

    fn(*args, device=device)
    reset_counts()
    card, secs = timed(lambda: fn(*args, device=device), device)
    add_counts("entry")
    equal_outputs(card, entry_ref.result(), "entry() on the card against the CPU")
    out["entry_seconds"] = secs

    PJ.analysis_step(batch[0], device=device, **kw)
    reset_counts()
    card, secs = timed(lambda: PJ.analysis_step(batch[0], device=device, **kw), device)
    launches = add_counts("analysis_step")
    for name in ("slic_assign", "eps_components"):
        check(launches[name] > 0, f"analysis_step launched {name} no time on the card")
    out["analysis_seconds"] = secs
    cpu_out, out["analysis_cpu_seconds"] = analysis_ref.result()
    equal_outputs(card, cpu_out, "analysis_step 768x512 on the card against the CPU")
    out["palette_count"] = int(card["palette_count"])

    stacked = np.stack(batch)
    PJ.batched_analysis_step(stacked, device=device, **kw)
    reset_counts()
    many, secs = timed(lambda: PJ.batched_analysis_step(stacked, device=device, **kw), device)
    add_counts("batched_analysis_step")
    out["batched_seconds"] = secs
    for k, img in enumerate(batch):
        one = card if k == 0 else PJ.analysis_step(img, device=device, **kw)
        equal_outputs({n: v[k] for n, v in many.items()}, one, f"batched_analysis_step row {k}")

    one = str(device) if device.type == "cpu" else f"cuda:{device.index or 0}"
    meshes = [M.make_mesh(2, devices=[one] * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(M.make_mesh(torch.cuda.device_count()))
    out["mesh"] = []
    for mesh in meshes:
        STREAM.encode_many(batch[:2], cfg.CodecConfig(), mesh=mesh)  # this mesh's first use
        reset_counts()
        datas, secs = timed(lambda: STREAM.encode_many(batch, cfg.CodecConfig(), mesh=mesh), device)
        add_counts(f"encode_many mesh {mesh.shape}")
        check(datas == batch_datas, f"encode_many on {mesh} differs from encode_many without a mesh")
        reset_counts()
        got, ssecs = timed(lambda: run_with_deadline(
            lambda: STREAM.encode_stream(batches[:2], cfg.CodecConfig(), workers=2, mesh=mesh),
            300.0, f"encode_stream on {mesh}"), device)
        add_counts(f"encode_stream mesh {mesh.shape}")
        check(got == stream_datas[:2], f"encode_stream on {mesh} differs from sequential encode_many")
        out["mesh"].append({"mesh": repr(mesh), "encode_many_seconds": secs, "encode_stream_seconds": ssecs})

    t0 = time.perf_counter()
    out["dryrun"] = entry.dryrun_multichip(2, devices=[one] * 2)
    out["dryrun_seconds"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as trace_dir:  # a trace of one encode is tens of MB
        for attempt in range(3):
            with profiling.device_trace(trace_dir) as prof:
                rtt.encode(batch[0], device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize()
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if kernels:
                break
        out["trace"] = {"bytes": os.path.getsize(prof.trace_path), "kernel_events": len(kernels),
                        "attempts": attempt + 1}
    check(bool(kernels), "three device traces of one encode held no kernel event")

    flops.enable()
    flops.reset()
    try:
        _, secs = timed(lambda: STREAM.encode_many(batch, cfg.CodecConfig(), device), device)
        ops, nbytes = flops.totals()
    finally:
        flops.disable()
        flops.reset()
    out["flops"] = {"executed_ops": ops, "bytes": nbytes, "wall_seconds": secs,
                    "share_of_peak": ops / secs / flops.H100_PEAK_F32}

    out["identity"] = cachekey.identity_report()
    notes = []
    out["fresh_before_prewarm"] = warmup.check_pack_freshness(log=notes.append)
    out["prewarm_entries"] = warmup.prewarm(block=True, device=device)
    out["fresh_after_prewarm"] = warmup.check_pack_freshness(log=notes.append)
    out["freshness_notes"] = notes
    check(out["fresh_after_prewarm"], f"the build pack is not fresh after prewarm: {notes}")
    out["launch_totals"] = totals
    return out


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
    if sys.argv[1:2] == ["--nonative-child"]:
        return nonative_child(sys.argv[2])

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.utils import device as DEV

    device = DEV.resolve(None)
    card = card_line()
    t_script = time.perf_counter()
    # -- 1. environment ------------------------------------------------------
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"[env] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    _, ld_name = native.libdeflate()
    print(f"[env] deflate: {ld_name or 'zlib (libdeflate not found; levels > 9 use zlib 9)'}")

    print(f"[time] phase 1 ended at {time.perf_counter() - t_script:.1f} s")
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

    print(f"[time] phase 2 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 3. kernel 1 -------------------------------------------------------------
    k1 = [check_slic_assign(device, form, *shape) for form in SLIC_FORMS
          for shape in SLIC_PATH_SHAPES + (SLIC_WIDEST_SHAPE,)]
    for r in k1:
        library = "bmm expanded+argmin" if r["form"] == "expanded" else "cdist+argmin"
        print(f"[slic_assign {r['form']}] B,MP,K={r['shape']}: ids equal "
              f"({r['ids_differing']} within an ulp); kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, {library} {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    print(f"[log32] {check_log32(device)} values: the card's log32 equals the CPU's bit for bit")
    k3 = [check_gumbel(device, GUMBEL_SEED, n, m) for n, m in GUMBEL_SHAPES]
    for r in k3:
        print(f"[gumbel] seed {r['seed']}, (n_draws, m) = {tuple(r['shape'])}: bits equal the host table; "
              f"kernel {r['ms']:.4f} ms (queued), host table {r['plain_ms']:.1f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    k4 = [check_kmeanspp(device, *shape) for shape in KMEANSPP_SHAPES]
    for r in k4:
        print(f"[kmeanspp] (B, m, n_draws, k_max) = {tuple(r['shape'])}, plan (cluster, threads, slice, "
              f"on chip) {tuple(r['plan'])}: centres equal the plain loop's bit for bit; kernel {r['ms']:.4f} ms "
              f"(queued), {r['step_us']:.2f} us a step; plain loop {r['plain_ms']:.2f} ms on the card, "
              f"{r['plain_host_ms']:.2f} ms host; bound {r['bound_ms']:.5f} ms ({r['bound_by']}) [{card}]")

    print(f"[time] phase 3 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 4. kernel 2 -------------------------------------------------------------
    k2, k2_packed = check_eps_sweep(device), check_eps_packed(device)
    for r in k2:
        print(f"[eps_sweep] B,N={r['shape']}: labels equal (kernel, plain, union-find); "
              f"{r['ms']:.3f} ms/sweep, plain {r['plain_ms']:.3f} ms/sweep, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")

    def report_loop(r):
        calls = r.get("driver_calls")
        counted = ""
        if calls is not None:
            traced = ("the profiler saw no device activity in 3 traces" if calls["kernels"] is None else
                      f"{len(calls['kernels'])} kernels {calls['kernels']}, {calls['copies']} copies/memsets")
            counted = (f"; one call = {calls['loop_launches']} loop launch by count, {traced}, "
                       f"{calls['syncs']} host synchronisations")
        print(f"[eps_loop] {r.get('entry', 'points')} B,N={r['shape']}: {r['sweeps']} rounds on the card "
              f"(plain loop {r['plain_sweeps']}, {r['plain_driver_ms']:.1f} ms), "
              f"whole call {r['driver_ms']:.3f} ms by the host clock (median of 5), "
              f"pack + loop kernels {r['loop_event_ms']:.3f} ms by CUDA events, "
              f"bound {r['bound_ms']:.4f} ms (every valid pair once){counted} [{card}]")
        check(calls is None or (calls["loop_launches"] == 1 and calls["syncs"] <= 2 and (
            calls["kernels"] is None or 1 <= len(calls["kernels"]) <= 4)),
              f"the eps loop at {r['shape']} ran {calls} for {r['sweeps']} rounds: it is not on the card")

    for r in k2 + k2_packed:
        report_loop(r)

    print(f"[time] phase 4 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 5. one image at a time ---------------------------------------------------
    results, launches_one, shapes, stages, idle, images_one, datas_one = run_end_to_end(device)
    for name in ("slic_assign_expanded", "eps_components", "eps_rounds", "gumbel", "kmeanspp"):
        check(launches_one[name] > 0, f"the one-image path launched {name} no time")
    check_seedings(launches_one, "the one-image path")
    print(f"[e2e] launches over {len(results)} encodes: {launches_one}")
    for name, hist in shapes.items():
        print(f"[e2e] launch shapes, {name}: {json.dumps(hist)}")
    print(f"[e2e] profiler window over the {len(results)} warm encodes: {json.dumps(idle)} [{card}]")
    for i, r in enumerate(results):
        print(f"[e2e] image {i}: {json.dumps(r)} [{card}]")
    mean_s = sum(r["seconds"] for r in results) / len(results)
    print(f"[e2e] warm seconds per 768x512 image: {mean_s:.3f} [{card}]")
    for name, st in stages.items():
        print(f"[e2e] stage {name}: {st['seconds']:.3f} s over {st['calls']} calls [{card}]")

    print(f"[time] phase 5 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 6. pairs -------------------------------------------------------------------
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    batches = [[synthetic_image(100 + 8 * k + i, 512, 768) for i in range(8)] for k in range(3)]
    pr = check_pairs(device, batches[0])
    print(f"[pairs] 8 x 512 x 768: uniq, counts, post-repair colors, painted map (uint8 and uint16) and "
          f"refit rows equal the host runtime's; {pr['n_pix']} pixels, {pr['n_masked']} in segments, "
          f"{pr['n_pairs']} pairs ({pr['n_pairs_repaired']} after the black repair)")
    print(f"[pairs] by CUDA events: sort {pr['sort_ms']:.3f} ms, compact {pr['compact_ms']:.3f} ms, "
          f"paint {pr['paint_ms']:.3f} ms, refit sums {pr['refit_ms']:.3f} ms; "
          f"host pack_pairs {pr['host_pack_ms']:.1f} ms (host clock) [{card}]")

    print(f"[time] phase 6 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 7. batch ---------------------------------------------------------------------
    runs = {}
    for label, config in (("default", cfg.CodecConfig()), ("low_latency", cfg.CodecConfig.low_latency())):
        br = runs[label] = run_batch(device, batches[0], config, profile=label == "default")
        for name in ("slic_assign_expanded", "eps_components", "eps_rounds", "gumbel", "kmeanspp"):
            check(br["launches"][name] > 0, f"the batch path ({label}) launched {name} no time")
        check_seedings(br["launches"], f"the batch path ({label})")
        print(f"[batch {label}] encode_many of 8 x 768x512: {br['seconds']:.3f} s warm, "
              f"{br['images_per_second']:.3f} images/s; bytes equal with RHCCQ_DEVICE_PAIRS=0 [{card}]")
        print(f"[batch {label}] launches: {br['launches']}")
        for name, hist in br["shapes"].items():
            print(f"[batch {label}] launch shapes, {name}: {json.dumps(hist)}")
        for i, r in enumerate(br["results"]):
            print(f"[batch {label}] image {i}: {json.dumps(r)}")
        for name, st in br["stages"].items():
            print(f"[batch {label}] stage {name}: {st['seconds']:.3f} s over {st['calls']} calls [{card}]")
        if br["idle"] is not None:
            print(f"[batch {label}] profiler window over one warm encode_many: {json.dumps(br['idle'])} [{card}]")
    launches_batch = runs["default"]["launches"]

    print(f"[time] phase 7 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 8. stream ------------------------------------------------------------------
    # Three batches on two workers: one worker takes a second batch, reusing
    # its thread's CUDA streams.  No profiler window here: phase 7 measures
    # the idle share, and a traced stream took two minutes of the script.
    sr = run_stream(device, batches, runs["default"]["datas"])
    for name in ("slic_assign", "eps_components", "eps_rounds", "gumbel", "kmeanspp"):
        check(sr["launches"][name] > 0, f"the stream path launched {name} no time")
    check_seedings(sr["launches"], "the stream path")
    print(f"[stream] encode_stream of {len(batches)} batches of 8, workers=2: equal to sequential encode_many byte "
          f"for byte; {sr['seconds']:.3f} s, {sr['images_per_second']:.3f} images/s "
          f"(sequential: {sr['sequential_seconds']:.3f} s, {sr['sequential_images_per_second']:.3f} images/s) [{card}]")
    print(f"[stream] launches: {sr['launches']}")
    for name, hist in sr["shapes"].items():
        print(f"[stream] launch shapes, {name}: {json.dumps(hist)}")

    print(f"[time] phase 8 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 9. cli ---------------------------------------------------------------------
    t_cli = time.perf_counter()
    cr = run_cli(device, images_one, datas_one)
    t_cli = time.perf_counter() - t_cli
    print(f"[cli] python3 -m roibasedimagecompression_torch encode: {cr['subprocess_line']}; bytes equal "
          f"to encode() of the same image [{card}]")
    for label, rec in cr["options"].items():
        same = "equal to" if rec.get("bytes_equal_cpu") else "within the phase-7 rule of"
        print(f"[cli] encode {label}: {rec['line']}; {same} --device cpu "
              f"(cpu {rec.get('cpu_seconds', 0):.1f} s); PSNR {rec['psnr_db']:.2f} dB [{card}]")
        print(f"[cli] encode {label} launches: {rec['launches']}")
        for name, hist in rec["shapes"].items():
            print(f"[cli] encode {label} launch shapes, {name}: {json.dumps(hist)}")
        print(f"[cli] encode {label} stages: {json.dumps({k: round(v, 4) for k, v in rec['stages'].items()})} [{card}]")
    print(f"[cli] eval: psnr {cr['eval']['psnr']:.4f} dB, ssim {cr['eval']['ssim']:.6f} (equal to "
          f"quality_metrics on the card); sweep: {cr['sweep_summary']}; compare: {json.dumps(cr['compare'])}")
    for name, secs in cr["seconds"].items():
        print(f"[cli] seconds, {name}: {secs:.3f} [{card}]")
    print(f"[cli] phase seconds: {t_cli:.1f}")
    launches_cli = {name: sum(rec["launches"][name] for rec in cr["options"].values())
                    for name in ("slic_assign", "slic_assign_expanded", "slic_assign_direct",
                                 "eps_components", "eps_sweep_alone", "eps_rounds", "gumbel", "kmeanspp",
                                 "kmeans_seed.kernel", "kmeans_seed.loop")}

    print(f"[time] phase 9 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 10. canvas -----------------------------------------------------------------
    t_canvas = time.perf_counter()
    cv = run_canvas(device, images_one, datas_one, batches[0][:4], runs["default"]["datas"][:4])
    for label, rec in cv["runs"].items():
        print(f"[canvas] {label}: {rec['seconds']:.3f} s; launches {rec['launches']} [{card}]")
        for name, hist in rec["shapes"].items():
            print(f"[canvas] {label} launch shapes, {name}: {json.dumps(hist)}")
        print(f"[canvas] {label} stages: {json.dumps({k: round(v, 4) for k, v in rec['stages'].items()})} [{card}]")
    print("[canvas] RHCCQ_CANVAS_TIERS=1: encode (2 images) and encode_many (4) byte-equal to the composed path; "
          f"fill_black_holes=10: {json.dumps(cv['results'])}; RHCCQ_SLIC_PALLAS=1 encode "
          f"{'equal to' if cv['runs']['encode, RHCCQ_SLIC_PALLAS=1'].get('bytes_equal_cpu') else 'within the rule of'} "
          f"the CPU [{card}]")
    print(f"[canvas] phase seconds: {time.perf_counter() - t_canvas:.1f}")
    launches_canvas = {name: sum(rec["launches"][name] for rec in cv["runs"].values())
                       for name in launches_cli}

    print(f"[time] phase 10 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 11. loop -------------------------------------------------------------------
    t_loop = time.perf_counter()
    lp = run_loop(device, images_one[0])
    for label, rec in lp["runs"].items():
        print(f"[loop {label}] encode of 768x512: {rec['seconds']:.3f} s on the card, "
              f"{rec['cpu_seconds']:.3f} s on the CPU, bytes equal; PSNR {rec['psnr_db']:.2f} dB, "
              f"{rec['bpp']:.3f} bpp [{card}]")
        print(f"[loop {label}] launches: {rec['launches']}")
        for name, hist in rec["shapes"].items():
            print(f"[loop {label}] launch shapes, {name}: {json.dumps(hist)}")
        print(f"[loop {label}] stages: {json.dumps({k: round(v, 4) for k, v in rec['stages'].items()})} [{card}]")
    print(f"[loop] box_density of the edge map (k = 3, 15, 25) on the card equals the CPU's bits; "
          f"ms by CUDA events: {json.dumps(lp['box_ms'])} [{card}]")
    print(f"[loop] phase seconds: {time.perf_counter() - t_loop:.1f}")
    launches_loop = {name: sum(rec["launches"][name] for rec in lp["runs"].values())
                     for name in launches_cli}

    print(f"[time] phase 11 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 12. options and the codec without its runtime ---------------------------
    t_opt = time.perf_counter()
    op = run_options(device, images_one[0])
    for label, rec in op.items():
        cpu_s = rec["cpu_seconds"]
        print(f"[options] {label}: {rec['seconds']:.3f} s on the card, {cpu_s:.3f} s on the CPU, "
              f"equal to the CPU (every output); PSNR {rec['psnr_db']:.2f} dB, {rec['bpp']:.3f} bpp [{card}]")
        print(f"[options] {label} launches: {rec['launches']}")
        for name, hist in rec["shapes"].items():
            print(f"[options] {label} launch shapes, {name}: {json.dumps(hist)}")
        if "stages" in rec:
            print(f"[options] {label} stages: {json.dumps({k: round(v, 4) for k, v in rec['stages'].items()})}")
    print(f"[options] phase seconds: {time.perf_counter() - t_opt:.1f}")
    t_nn = time.perf_counter()
    nn = run_nonative()
    for label, rec in nn["runs"].items():
        held = ("no CPU run (phase 15 holds it)" if rec["cpu_seconds"] is None else
                f"{rec['cpu_seconds']:.3f} s on the CPU, bytes equal under RHCCQ_NATIVE=0")
        print(f"[nonative] {label}: {rec['seconds']:.3f} s on the card, {held}; {rec['cc_passes']} propagation passes; PSNR "
              f"{[round(p, 2) for p in rec['psnr_db']]} dB, bpp {[round(b, 3) for b in rec['bpp']]} [{card}]")
        print(f"[nonative] {label} launches: {rec['launches']}")
        for name, hist in rec["shapes"].items():
            print(f"[nonative] {label} launch shapes, {name}: {json.dumps(hist)}")
        print(f"[nonative] {label} stages: {json.dumps(rec['stages'])} [{card}]")
    for label, rec in nn["cc"].items():
        print(f"[nonative] propagation, {label}: {rec['passes']} passes, {rec['ms']:.3f} ms, "
              f"{rec['ms_per_pass']:.3f} ms a pass by CUDA events [{card}]")
    print(f"[nonative] phase seconds: {time.perf_counter() - t_nn:.1f}")
    launches_options = {name: sum(rec["launches"][name] for rec in op.values()) for name in launches_cli}
    launches_nonative = {name: sum(rec["launches"][name] for rec in nn["runs"].values())
                         for name in launches_cli}

    print(f"[time] phase 12 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 13. side modules -------------------------------------------------------------
    t_side = time.perf_counter()
    # The CPU references of phases 13 and 14 run on a thread of their own
    # while the card runs its calls.
    refs = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-refs")
    sd = run_side(device, batches[0][2], refs)
    for label, rec in sd.items():
        print(f"[side] {label}: {json.dumps(rec)} [{card}]")
    print("[side] thinning, the five connect strategies, remove_thin_structures_v1 and the watershed "
          f"equal on the card and the CPU; bilateral {'equal' if not sd['bilateral_diff']['pixels'] else 'within 1 level on <= 0.1 %'}")
    print(f"[side] phase seconds: {time.perf_counter() - t_side:.1f}")

    print(f"[time] phase 13 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 14. entry surface ------------------------------------------------------------
    t_drv = time.perf_counter()
    dv = run_entry_surface(device, batches, sr["datas"], refs)
    refs.shutdown()
    print(f"[entry] entry() (256 x 256) on the card: {dv['entry_seconds']:.3f} s, nine outputs equal to the CPU [{card}]")
    print(f"[entry] analysis_step 768x512 (8 x 8 centres, 4096 slots, {dv['palette_count']} colours): "
          f"{dv['analysis_seconds']:.3f} s warm on the card, {dv['analysis_cpu_seconds']:.3f} s on the CPU, "
          f"nine outputs equal [{card}]")
    print(f"[entry] batched_analysis_step of 8: {dv['batched_seconds']:.3f} s warm, each row equal to its "
          f"image's own call [{card}]")
    for label, rec in dv["launches"].items():
        print(f"[entry] {label} launches: {rec}")
        for name, hist in dv["shapes"][label].items():
            print(f"[entry] {label} launch shapes, {name}: {json.dumps(hist)}")
    for rec in dv["mesh"]:
        print(f"[entry] {rec['mesh']}: encode_many of 8 {rec['encode_many_seconds']:.3f} s (without a mesh "
              f"{runs['default']['seconds']:.3f} s), encode_stream of 2 batches {rec['encode_stream_seconds']:.3f} s; "
              f"bytes equal to the runs without a mesh [{card}]")
    print(f"[entry] dryrun_multichip(2, cuda:0 x 2): {dv['dryrun_seconds']:.1f} s, {json.dumps(dv['dryrun'])}")
    print(f"[entry] device_trace of one encode: {json.dumps(dv['trace'])}")
    print(f"[entry] operation-counted encode_many of 8: {json.dumps(dv['flops'])} [{card}]")
    print(f"[entry] identity: {json.dumps(dv['identity'])}")
    print(f"[entry] build pack fresh before prewarm {dv['fresh_before_prewarm']}, after "
          f"{dv['fresh_after_prewarm']} ({dv['prewarm_entries']} manifest entries); {dv['freshness_notes']}")
    print(f"[entry] phase seconds: {time.perf_counter() - t_drv:.1f}")
    launches_entry = dv["launch_totals"]

    print(f"[time] phase 14 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 15. parity with the JAX package -------------------------------------------
    # The card's 768x512 encodes against the JAX package's answers, read from
    # tests/data/jax_parity_768x512.json: those phases 5, 7 and 9-12 made,
    # then new seed-102 encodes (ROI pixels) of the rows no phase runs there.
    t_par = time.perf_counter()

    def flags(recs):
        return [r.get("bytes_equal_cpu") for r in recs]

    f5, f7 = flags(results), flags(runs["default"]["results"])
    opts = cr["options"]
    held = [
        ("a", (100, 101), datas_one, f5, "phase 5"),
        ("b", tuple(range(100, 108)), runs["default"]["datas"], f7, "phase 7"),
        ("c", tuple(range(100, 108)), runs["low_latency"]["datas"], flags(runs["low_latency"]["results"]),
         "phase 7, low_latency()"),
        ("h0", (101,), [opts["defaults"]["data"]], flags([opts["defaults"]]), "phase 9, CLI defaults"),
        ("h0", (101,), [opts["container-level-7"]["data"]], flags([opts["container-level-7"]]),
         "phase 9, --container-level 7"),
        ("h1", (101,), [opts["mediancut"]["data"]], flags([opts["mediancut"]]), "phase 9"),
        ("h2", (101,), [opts["kmeans-mc"]["data"]], flags([opts["kmeans-mc"]]), "phase 9"),
        ("h3", (101,), [opts["enhance-shadows"]["data"]], flags([opts["enhance-shadows"]]), "phase 9"),
        ("i1", (100, 101), cv["datas"]["canvas encode"], f5, "phase 10"),
        ("i2", (100, 101, 102, 103), cv["datas"]["canvas encode_many"], f7[:4], "phase 10"),
        ("i3", (100, 101), cv["datas"]["fill encode"], flags(cv["results"][:2]), "phase 10"),
        ("i4", (100, 101, 102, 103), cv["datas"]["fill encode_many"], flags(cv["results"][2:]), "phase 10"),
        ("d", (100,), cv["datas"]["pallas encode"], flags([cv["runs"]["encode, RHCCQ_SLIC_PALLAS=1"]]),
         "phase 10"),
        ("e2", (100,), [lp["runs"]["single_region"]["data"]], [True], "phase 11"),
        ("e1", (100,), [lp["runs"]["roi"]["data"]], [True], "phase 11"),
        ("f1", (100,), [op["encode, region_fusion=True"]["data"]], [True], "phase 12"),
        ("f2", (100,), [op["encode, weighted_split=True"]["data"]], [True], "phase 12"),
        ("f3", (100,), [op["loop, region_fusion=True, weighted_split=True"]["data"]], [True], "phase 12"),
        ("j1", (100,), nn["runs"]["encode"]["digests"], [True], "phase 12's child"),
        ("j2", (100, 101), nn["runs"]["encode_many of 2"]["digests"], [None, None], "phase 12's child"),
        ("j3", (100,), nn["runs"]["loop"]["digests"], [True], "phase 12's child"),
    ]
    par = run_parity(device, held, batches[0][2], nn["parity"])
    for rec in par["rows"]:
        print(f"[parity] {json.dumps(rec)} [{card}]")
    for row, rec in par["launches"].items():
        print(f"[parity] row {row} seed 102 launches: {rec}")
    n_equal = sum(r["digest_equal"] for r in par["rows"])
    parity_line = json.dumps({"parity": {"rows": len(par["rows"]), "equal": n_equal,
                                         "open": sorted({r["row"] for r in par["rows"] if r["row"] in PARITY_OPEN})}})
    print(f"[parity] {n_equal} of {len(par['rows'])} card encodes carry the JAX package's payload digest; "
          f"row b's {par['ssim_checked']} decodes score the file's PSNR and SSIM on the card")
    print(f"[parity] phase seconds: {time.perf_counter() - t_par:.1f}")
    launches_parity = par["launch_totals"]

    print(f"[time] phase 15 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 16. cover ------------------------------------------------------------------
    # Whatever shape a path launched a kernel at, beyond those of phases 3 and
    # 4, is held against the plain version here.
    def slic_key(r):
        return (r["form"], *r["shape"])

    more = sorted(launched_shapes["slic_assign"] - {slic_key(r) for r in k1})
    k1 += [check_slic_assign(device, *key) for key in more]
    more_eps = sorted(launched_shapes["eps_components"] - {tuple(r["shape"]) for r in k2_packed})
    for r in check_eps_packed(device, more_eps, count_calls=False):  # phase 4 counted one call's kernels
        report_loop(r)
        k2_packed.append(r)
    t_cover = time.perf_counter()
    more_gumbel = sorted(launched_shapes["gumbel"] - {(r["seed"], *r["shape"]) for r in k3})
    k3 += [check_gumbel(device, seed, n, m, timed=False) for seed, n, m in more_gumbel]
    print(f"[cover] the Gumbel kernel also checked at (seed, n_draws, m) {more_gumbel}: bits equal "
          f"the host table ({time.perf_counter() - t_cover:.1f} s of host tables)")
    for r in k3:
        r["on_path"] = (r["seed"], *r["shape"]) in launched_shapes["gumbel"]
    t_cover = time.perf_counter()
    more_kpp = sorted(launched_shapes["kmeanspp"] - {tuple(r["shape"]) for r in k4})
    k4 += [check_kmeanspp(device, *shape, timed=False) for shape in more_kpp]
    print(f"[cover] the k-means++ kernel also checked at (B, m, n_draws, k_max) {more_kpp}: centres equal "
          f"the plain loop's ({time.perf_counter() - t_cover:.1f} s)")
    for r in k4:
        r["on_path"] = tuple(r["shape"]) in launched_shapes["kmeanspp"]
    for r in k1:
        r["on_path"] = slic_key(r) in launched_shapes["slic_assign"]
    for r in k2_packed:
        r["on_path"] = tuple(r["shape"]) in launched_shapes["eps_components"]
    print(f"[cover] slic_assign also checked at {more}, the packed eps loop at {more_eps}: every "
          f"shape the paths launched ({len(launched_shapes['slic_assign'])} and "
          f"{len(launched_shapes['eps_components'])}) is held against the plain version; checked "
          f"but launched by no path: slic_assign {[slic_key(r) for r in k1 if not r['on_path']]}, "
          f"packed eps loop {[r['shape'] for r in k2_packed if not r['on_path']]}")

    print(f"[time] phase 16 ended at {time.perf_counter() - t_script:.1f} s")
    # -- 17. kernels line ------------------------------------------------------------
    # `launches` count the main paths, each read around its own run from 0:
    # the one-image encodes of phase 5, the warm encode_many at CodecConfig()
    # of phase 7, the in-process CLI encodes of phase 9, the canvas runs of
    # phase 10 (kernel 1's direct form runs in its RHCCQ_SLIC_PALLAS=1
    # encode), the loop's two encodes of phase 11, phase 12's option runs and
    # runs without the runtime, phase 14's entry surface (entry(),
    # analysis_step, batched_analysis_step and the mesh encodes) and phase
    # 15's new seed-102 encodes; the stream's are beside them.
    def launches_of(name):
        return {"launches": launches_one[name] + launches_batch[name] + launches_cli[name]
                + launches_canvas[name] + launches_loop[name] + launches_options[name]
                + launches_nonative[name] + launches_entry[name] + launches_parity[name],
                "launches_parity": launches_parity[name],
                "launches_one_image": launches_one[name], "launches_batch": launches_batch[name],
                "launches_cli": launches_cli[name], "launches_canvas": launches_canvas[name],
                "launches_loop": launches_loop[name], "launches_options": launches_options[name],
                "launches_nonative": launches_nonative[name], "launches_entry": launches_entry[name],
                "launches_stream": sr["launches"][name]}

    # The headline numbers of each entry are those of the largest shape a path
    # launched it at (by pixels, B * MP, and by pairs, B * N * N): (8, 221184,
    # 64) and (48, 9999) on the smoke's images; `per_shape` has every shape
    # checked.
    big = k2[-1]
    big_packed = max((r for r in k2_packed if r["on_path"]),
                     key=lambda r: r["shape"][0] * r["shape"][1] ** 2)

    def slic_entry(form):
        rows = [r for r in k1 if r["form"] == form]
        head = max((r for r in rows if r["on_path"]), key=lambda r: r["shape"][0] * r["shape"][1])
        return ({k: head[k] for k in ("name", "route", "source", "replaces", "form")}
                | launches_of(f"slic_assign_{form}")
                | {"max_abs_err": max(r["max_abs_err"] for r in rows), "shape": head["shape"],
                   "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                   "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                   "per_shape": [{k: r[k] for k in ("shape", "on_path", "ms", "plain_ms", "bound_ms",
                                                    "library_ms")} for r in rows]})

    kernels = [
        slic_entry("expanded"),
        slic_entry("direct"),
        {"name": "eps_sweep", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/epscc.cu",
         "replaces": "roibasedimagecompression_tpu/ops/pallas/epscc.py:33"}
        # On the main paths the sweep's code runs inside the loop kernel
        # (eps_components_kernel), so `launches` are that kernel's, counted
        # beside its launch; the sweep kernel alone (eps_sweep_kernel, which
        # `ms` times) is launched by no encode.
        | launches_of("eps_components")
        | {"launches_alone": launches_one["eps_sweep_alone"] + launches_batch["eps_sweep_alone"]
                            + launches_cli["eps_sweep_alone"] + launches_loop["eps_sweep_alone"]
                            + launches_options["eps_sweep_alone"] + launches_nonative["eps_sweep_alone"]
                            + launches_entry["eps_sweep_alone"] + launches_parity["eps_sweep_alone"],
           "max_abs_err": max(r["max_abs_err"] for r in k2),
           "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
           "bound_by": big["bound_by"], "library_ms": None,
           "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")} for r in k2]},
        {"name": "eps_components", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/epscc.cu",
         "replaces": "roibasedimagecompression_tpu/ops/pallas/epscc.py:97"}
        | launches_of("eps_components")
        | {"rounds": launches_one["eps_rounds"] + launches_batch["eps_rounds"] + launches_cli["eps_rounds"]
                     + launches_loop["eps_rounds"] + launches_options["eps_rounds"]
                     + launches_nonative["eps_rounds"] + launches_entry["eps_rounds"]
                     + launches_parity["eps_rounds"],
           "max_abs_err": max(r["loop_max_abs_err"] for r in k2 + k2_packed),
           # One whole call (pack, loop kernel, read-back) through the packed
           # entry at the largest shape a path launched; its bound is one
           # sweep's: every valid pair looked at once.  `loop_event_ms` is the
           # pack and loop kernels alone, by CUDA events.
           "shape": big_packed["shape"],
           "ms": big_packed["driver_ms"], "plain_ms": big_packed["plain_driver_ms"],
           "bound_ms": big_packed["bound_ms"], "bound_by": big_packed["bound_by"],
           "library_ms": None, "loop_event_ms": big_packed["loop_event_ms"],
           "per_shape": [{"shape": r["shape"], "entry": "points", "sweeps": r["sweeps"],
                          "driver_ms": r["driver_ms"], "loop_event_ms": r["loop_event_ms"],
                          "plain_driver_ms": r["plain_driver_ms"],
                          "bound_ms": r["bound_ms"]} for r in k2]
                        + [{k: r[k] for k in ("shape", "entry", "on_path", "sweeps", "components", "driver_ms",
                                              "loop_event_ms", "plain_driver_ms", "bound_ms")}
                           for r in k2_packed]},
        # Kernel 3 has no Pallas counterpart: the JAX package draws this
        # noise in XLA inside its jitted k-means.  Its headline is the
        # reference size (256, 16384); `on_path` in `per_shape` marks the
        # tables the paths drew.  `ms` is queued card time (time_queued_ms),
        # `plain_ms` one host table's draw.
        {"name": "gumbel", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/gumbel.cu",
         "replaces": "roibasedimagecompression_tpu/ops/cluster.py:203,216 (jax.random.categorical's Gumbel draw, in XLA)"}
        | launches_of("gumbel")
        | {"max_abs_err": 0.0, "shape": k3[0]["shape"], "ms": k3[0]["ms"], "plain_ms": k3[0]["plain_ms"],
           "bound_ms": k3[0]["bound_ms"], "bound_by": k3[0]["bound_by"], "library_ms": None,
           "per_shape": [{k: r.get(k) for k in ("seed", "shape", "on_path", "ms", "plain_ms", "bound_ms")}
                         for r in k3]},
        # Kernel 4 has no Pallas counterpart either: the JAX package seeds
        # k-means++ in XLA (a fori_loop of categorical draws).  Its headline
        # is tier 1's (1, 32768, 189, 256); `ms` is queued card time,
        # `step_us` its time a step, `plain_ms` the Python step a centre on
        # the card (`plain_host_ms` its host time).
        {"name": "kmeanspp", "route": "cuda",
         "source": "roibasedimagecompression_torch/csrc/kmeanspp.cu",
         "replaces": "roibasedimagecompression_tpu/ops/cluster.py:196-232 (kmeans' k-means++ fori_loop, in XLA)"}
        | launches_of("kmeanspp")
        | {"max_abs_err": 0.0, "shape": k4[1]["shape"], "ms": k4[1]["ms"], "step_us": k4[1]["step_us"],
           "plain_ms": k4[1]["plain_ms"], "plain_host_ms": k4[1]["plain_host_ms"],
           "bound_ms": k4[1]["bound_ms"], "bound_by": k4[1]["bound_by"], "library_ms": None,
           "per_shape": [{k: r.get(k) for k in ("shape", "plan", "on_path", "ms", "step_us", "plain_ms",
                                                "plain_host_ms", "bound_ms")} for r in k4]},
    ]
    print(f"[kmeanspp] launches over the smoke's paths: {launches_of('kmeanspp')}")
    print(parity_line)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
