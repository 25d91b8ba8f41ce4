"""Multi-device scaling accounting for the encode pipeline.

The counterpart of the JAX package's `parallel/scaling.py`; `split_profile`
and `projected_throughput` are its accounting, copied.  Per-image
independence makes the codec data-parallel (`encode_many(mesh=...)` splits
every bucketed device stage's rows over the mesh's data devices, byte for
byte the one-device result).  What N devices gain is bounded by the stages
that stay serial on the host:

  - host-serial top-level stages (HOST_TOP): threshold selection and the ROI
    mask chain run in the native runtime on the host, region extraction is
    host bookkeeping, and the DEFLATE container is host zlib;
  - host-serial stages inside `s.tier1` (HOST_IN_TIER1): `t1.pairs` (the
    host radix pack of the pair table; the device table is `t1.pairs_dev`,
    device time), `t1.means` (native cluster means) and `epscc.kmeans`, the
    >= 10k-colour k-means, whose k-means++ initialisation takes one
    host-driven step per centre (the card idles through it).  The eps-CC
    labels (`epscc.labels`) run on the card, in kernel 2, and are device
    time, as are the split score, SLIC, the k-means splits and tiers 2/3.

`shard_work_ratio` counts the per-device work of the banded stencil frontend
with `utils/flops.py`'s counter.
"""

from __future__ import annotations

import numpy as np
import torch

TOP_STAGES = (
    "s.thresholds", "s.roi_masks", "s.extract", "s.segment",
    "s.tier1", "s.tier23", "s.container",
)
HOST_TOP = {"s.thresholds", "s.roi_masks", "s.extract", "s.container"}
HOST_IN_TIER1 = ("t1.pairs", "t1.means", "epscc.kmeans")


def split_profile(stages: dict) -> tuple[float, float]:
    """(host_seconds, device_parallel_seconds) from a stage-timer report."""
    get = lambda k: float(stages.get(k, 0.0))  # noqa: E731
    host = sum(get(k) for k in HOST_TOP) + sum(get(k) for k in HOST_IN_TIER1)
    total = sum(get(k) for k in TOP_STAGES)
    return host, max(total - host, 0.0)


def projected_throughput(stages: dict, megapixels: float, n_chips: int):
    """Projected MP/s at n_chips for (single-host, host-per-chip) topologies.

    The single-host projection is the Amdahl bound with host stages serial;
    the host-per-chip projection divides host work across hosts (images are
    independent, so the division is exact, not approximate).
    """
    host, device = split_profile(stages)
    t1 = host + device
    single_host = megapixels / (host + device / n_chips) if t1 else 0.0
    host_per_chip = megapixels / (t1 / n_chips) if t1 else 0.0
    return {
        "host_s": round(host, 3),
        "device_s": round(device, 3),
        "single_host_mpps": round(single_host, 3),
        "host_per_chip_mpps": round(host_per_chip, 3),
    }


def shard_work_ratio(mesh, shape=(8, 64, 64, 3)) -> dict:
    """Per-device work of the banded stencil frontend against the same
    frontend on one device: executed operations counted by `utils/flops.py`
    (elementwise ops at one an element; the frontend has no products), the
    halo rows included.  Returns {"flops_1dev", "flops_per_dev" (the most
    any device runs), "ratio"}."""
    from roibasedimagecompression_torch.parallel import mesh as M
    from roibasedimagecompression_torch.utils import flops

    images = np.zeros(shape, np.uint8)
    b, h = shape[:2]
    n_data, n_space = mesh.devices.shape
    per = b // n_data
    was_on = flops.enabled()
    flops.enable()
    try:
        def count(imgs) -> float:
            before = flops.totals()[0]
            flops.track(M._frontend, (torch.from_numpy(imgs),), {})
            return flops.totals()[0] - before

        f1 = count(images)
        per_dev = []
        for r0, r1 in M._bands(h, n_space):
            lo, hi = max(0, r0 - M._DENSITY_REACH), min(h, r1 + M._DENSITY_REACH)
            per_dev.append(count(np.ascontiguousarray(images[:per, lo:hi])))
    finally:
        if not was_on:
            flops.disable()
    fn = max(per_dev)
    return {"flops_1dev": f1, "flops_per_dev": fn, "ratio": round(f1 / fn, 2) if fn else 0.0}
