"""Time the port's quality metrics on the card at Kodak's shape (768x512).

Imports `roibasedimagecompression_torch` from the checkout given by
`--root` (this repository by default), so that two trees can be compared in
one run on the same card:

    python3 scripts/time_metrics.py --root /path/to/other/checkout

Times `quality_metrics` and `ssim_map` of `synthetic_image(102, 512, 768)`
against a copy with seeded noise, and `ssim` of the same images as CUDA
tensors: one warm call, then the median of `--reps` calls by the host
clock (each call ends on the host, so the clock covers the card's work).
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from roibasedimagecompression_torch.ops import metrics
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    assert os.path.dirname(os.path.abspath(metrics.__file__)).startswith(root)
    img = synthetic_image(102, 512, 768)
    noise = np.random.default_rng(0).integers(-12, 13, img.shape)
    rec = np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    ta, tb = torch.from_numpy(img).cuda(), torch.from_numpy(rec).cuda()

    calls = {
        "quality_metrics": lambda: metrics.quality_metrics(img, rec, device="cuda"),
        "ssim_map": lambda: metrics.ssim_map(img, rec, device="cuda"),
        "ssim": lambda: float(metrics.ssim(ta, tb)),
    }
    out = {"root": root, "shape": list(img.shape)}
    for name, fn in calls.items():
        value = fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms_median": statistics.median(times), "ms_all": times}
        if name == "quality_metrics":
            out[name]["ssim"], out[name]["psnr"] = value["ssim"], value["psnr"]
        elif name == "ssim_map":
            out[name]["mean"] = float(np.mean(value))
        else:
            out[name]["value"] = value
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
