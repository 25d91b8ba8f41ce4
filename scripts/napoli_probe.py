#!/usr/bin/env python3
"""Sizing probe of the upstream project's largest input on the card: one
`encode_many` of a 6064x3660 photograph (22.2 Mpix, the size of
`images/rhccq/Napoli_compressed.rhccq`) at `CodecConfig()`.

    python3 scripts/napoli_probe.py [--out FILE.json] [--encodes 2] [--trace]

The image is `portbench/images.py synthetic_image(100, 3660, 6064)`.  After a
warm encode of one 768x512 image (CUDA's start-up, the kernels' builds), it
encodes the image `--encodes` times and records for each: the request's wall
seconds, the stage split (`utils/timing.py`), the Lloyd loop's seconds
(`kmeans.lloyd`), the counters (`kmeans_assign_pairs`, `kmeans_iters`,
`kmeans_assign.*`), the hand-written kernels' launches with the largest
(B, m, k_max) of the Lloyd assignment, the container's size and the peak
device memory.  With `--trace`, one more encode under `torch.profiler`
counts the device's kernels, copies and sets and its busy seconds.  Prints
one JSON line, and writes it to `--out` where given; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "nvidia-smi unavailable"


def encode_once(image, config, device) -> dict:
    import torch

    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import timing

    timing.reset_stages()
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = STREAM.encode_many([image], config, device)[0]
    seconds = time.perf_counter() - t0
    lloyd = _build.launched["lloyd_assign"]
    widest = max(lloyd, key=lambda key: (key[2], key[1]), default=None)
    return {
        "seconds": seconds,
        "bytes": len(data),
        "stages": {k: round(v["seconds"], 4) for k, v in timing.stage_report().items()},
        "stage_calls": {k: v["calls"] for k, v in timing.stage_report().items()},
        "counters": timing.counters(),
        "launches": {name: c.total() for name, c in _build.launched.items()},
        "lloyd_shapes (B, m, k_max)": {str(k): n for k, n in sorted(lloyd.items())},
        "largest_k_max (B, m, k_max)": list(widest) if widest else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }, data


def traced(image, config, device) -> dict:
    import torch

    from roibasedimagecompression_torch.parallel import stream as STREAM

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        STREAM.encode_many([image], config, device)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    return {"seconds": seconds, "device_ops": len(dev), "device_busy_s_summed": busy}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--encodes", type=int, default=2)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("napoli_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.images import synthetic_image
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.models import codec
    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import device as DEV

    device = DEV.resolve(None)
    config = cfg.CodecConfig()
    native.build()
    _build.build_all()
    STREAM.encode_many([synthetic_image(100, 512, 768)], config, device)
    t0 = time.perf_counter()
    image = synthetic_image(100, 3660, 6064)
    out = {"card": card_line(), "torch": torch.__version__, "shape": list(image.shape),
           "image_seconds": time.perf_counter() - t0, "encodes": []}
    data = None
    for _ in range(args.encodes):
        rec, data = encode_once(image, config, device)
        out["encodes"].append(rec)
        print(json.dumps({"encode": rec}), flush=True)
    back = codec.decode(data)
    mse = float(np.mean((back.astype(np.float64) - image.astype(np.float64)) ** 2))
    out["psnr_db"] = 10 * np.log10(255.0**2 / mse) if mse > 0 else float("inf")
    if args.trace:
        out["traced"] = traced(image, config, device)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
