#!/usr/bin/env python3
"""Benchmark of `roibasedimagecompression_torch` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--control refit_off]

One run: set-up (import, load or build the program's kernels and host
runtime, make the cell's image set and its order from the seed, warm the
cell's own requests), then the measured window of `--seconds`, driven by the
cell's traffic mix, then with `--trace 1` one bounded profiler slice (the
cycle's first requests again), then the reference's check of every answer.  The last line of standard output is
one JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `checks`: each number compared beside its
limit); the last lines of standard error repeat the checks.  `--trace 0`
reports the cell's end-to-end metrics, `--trace 1` its per-layer metrics.

`--control refit_off` runs the program with its palette refit switched off,
a guarantee both configurations state: the check has to fail it.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when the program cannot be imported, or when a module of
JAX or of the JAX package is loaded by the time the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness as H  # noqa: E402
from portbench import images as IM  # noqa: E402
from portbench import trace as TR  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prepare_environment() -> None:
    """Keep every cache inside the checkout, at fixed paths, and run the
    program as its configuration states: no `RHCCQ_*` switch from outside."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    for key in [k for k in os.environ if k.startswith("RHCCQ_")]:
        log(f"portbench: ignoring {key} from the environment")
        del os.environ[key]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi unavailable"


def host_report(t0: float, cpu0: float, device: str) -> dict:
    """What could set one run's host speed apart from another's, for the
    window that began at `t0` (host clock) with `cpu0` CPU seconds spent:
    the cores the process may use, torch's thread pools, the Python threads
    alive, the window's CPU seconds (all threads) and their share of its
    wall time, a fixed one-thread and a fixed torch-threaded probe timed
    after the window, and the card's clocks.  Diagnostics only: no metric
    reads them."""
    import threading

    import numpy as np
    import torch

    wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    out = {"cores": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
           "torch_threads": torch.get_num_threads(),
           "interop_threads": torch.get_num_interop_threads(),
           "py_threads": threading.active_count(), "window_cpu_s": cpu,
           "cpu_per_wall": cpu / wall}
    x = np.random.default_rng(0).random(1 << 21)
    t = time.perf_counter()
    for _ in range(4):
        np.sort(x)
    out["probe_sort_ms"] = 1e3 * (time.perf_counter() - t)
    a = torch.ones((1024, 1024))
    t = time.perf_counter()
    for _ in range(20):
        a @ a
    out["probe_matmul_ms"] = 1e3 * (time.perf_counter() - t)
    if device == "cuda":
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                 "clocks_throttle_reasons.active", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60)
            out["card"] = smi.stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as exc:
            out["card"] = f"nvidia-smi unavailable ({exc})"
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=sorted(H.CONTROLS), default=None)
    return ap.parse_args(argv)


def run(args, device: str = "cuda", t_start: float = T_START, bench: dict | None = None,
        wrap_call=None) -> dict:
    """Set-up, window, slice and check of one run on `device`; returns the
    result object.  `bench` defaults to the checkout's BENCHMARK.json;
    `wrap_call`, when given, wraps the entry point's call (the tests use it
    to break the timed path)."""
    import torch

    if bench is None:
        bench = H.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = H.resolve(bench, args.workload)
    traffic = cell.traffic

    # ---- set-up ----
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.ops.cuda import slic_assign as SA
    from roibasedimagecompression_torch.utils import timing

    if device == "cuda":
        _build.build_all()
    native.available()
    config = H.codec_config(cell, args.control)
    images = IM.image_set(cell.config["images"])
    batch = int(traffic["batch"])
    order = IM.arrival_order(cell.config["images"]["ids"], args.seed)
    call = H.load_module("entries", traffic["entry"]).make(config, device)
    if wrap_call is not None:
        call = wrap_call(call)
    driver = H.load_module("drivers", traffic["driver"])
    stream = H.requests(order, images, batch)
    warm = [next(stream) for _ in range(int(traffic["warmup_requests"]))]
    records = []
    for ids, imgs in warm:
        records.append({"ids": ids, "answers": call(imgs), "error": None})
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: set-up {setup_s:.3f} s")

    # ---- the measured window ----
    timing.reset_stages()
    t_host, cpu0 = time.perf_counter(), time.process_time()
    t0, window = driver.drive(call, stream, args.seconds)
    stages = timing.stage_report()
    host = host_report(t_host, cpu0, device)
    for rec in window:
        rec["in_window"] = True
    records.extend(window)
    t_end = window[-1]["end"] if window else time.perf_counter()
    n_images = sum(len(r["ids"]) for r in window)
    h, w = int(cell.config["images"]["height"]), int(cell.config["images"]["width"])
    log(f"portbench: window {t_end - t0:.3f} s, {len(window)} requests, {n_images} images; "
        "seconds by first id: " + " ".join(f"{r['ids'][0]}:{r['end'] - r['start']:.3f}" for r in window))
    log(f"portbench: host {json.dumps(host)}")

    # ---- the traced slice ----
    slice_ = None
    if args.trace:
        # The slice is the cycle's first requests, whatever the window held,
        # so every traced run reads the same work.
        traced = list(itertools.islice(H.requests(order, images, batch),
                                       int(traffic["trace_requests"])))
        shapes0 = dict(SA.launch_shapes)

        def slice_fn():
            for ids, imgs in traced:
                records.append({"ids": ids, "answers": call(imgs), "error": None})
            return sum(len(ids) for ids, _ in traced)

        slice_ = TR.profile_slice(slice_fn)
        slice_.counters["slic_assign_shapes"] = {
            key: n - shapes0.get(key, 0) for key, n in SA.launch_shapes.items()
            if n - shapes0.get(key, 0) > 0
        }

    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    loaded = H.forbidden_loaded()
    if loaded:
        raise SystemExit(f"portbench: modules that no run may load: {', '.join(loaded)}")

    # ---- metrics ----
    ctx = types.SimpleNamespace(
        window_start=t0, window_end=t_end, requests=window, images=n_images,
        pixels=n_images * h * w, stages=stages, trace=slice_,
    )
    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            reader, suffix = H.metric_reader(m["name"])
            value = reader.read(ctx, suffix)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": n_images, "failed": 0, "metrics": metrics,
              "device": device_info}
    if slice_ is not None:
        device_info["busy_s"] = TR.busy_seconds(slice_.device)
        device_info["window_s"] = slice_.window_s
        result["breakdown"] = {"device_ops": TR.top_device_ops(slice_.device),
                               "idle_gaps": TR.idle_gaps(slice_.device, slice_.host)}

    # ---- the reference's check, after the window and the memory reading ----
    t_check = time.perf_counter()
    judged = H.check_answers(records, images, cell.digests, traffic["entry"])
    result["failed"] = judged["failed"]
    result["checks"] = judged["checks"]
    result["correct"] = judged["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in judged["checks"].values())
    log(f"portbench: checked {sum(len(r['ids']) for r in records)} answers in "
        f"{time.perf_counter() - t_check:.3f} s")
    for rec in records:
        if rec["error"]:
            log(f"portbench: a request failed: {rec['error']}")
            break
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    prepare_environment()
    import torch

    bench = H.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = H.resolve(bench, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    log(f"portbench: card {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(args)
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
