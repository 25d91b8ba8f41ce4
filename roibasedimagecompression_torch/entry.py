"""Entry hooks of the port: a one-device check of the fused device core and
the multi-device dry run.

The counterpart of the repository's `__graft_entry__.py` for the JAX
package.  `entry()` returns the core on a 256 x 256 image; `dryrun_multichip`
runs every sharded path of the port on an n-device mesh and checks that the
sharded encodes are byte for byte the one-device ones.

    from roibasedimagecompression_torch import entry
    fn, args = entry.entry()
    out = fn(*args)                                   # on the card
    entry.dryrun_multichip(4, devices=["cpu"] * 4)    # a CPU mesh
"""

from __future__ import annotations

import numpy as np
import torch


def entry():
    """(fn, args): the codec's fused device core (adaptive Canny, SLIC over an
    8 x 8 grid, palette clustering at quality 20, 4096 palette slots) on a
    256 x 256 image from default_rng(0); fn runs on the card."""
    from roibasedimagecompression_torch.models import pipeline_jit

    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)

    def fn(image_rgb, device=None):
        return pipeline_jit.analysis_step(
            image_rgb, n_centers_side=8, palette_cap=4096, quality=20.0, device=device
        )

    return fn, (image,)


def _stage_seconds(report: dict) -> dict:
    return {k: v["seconds"] for k, v in report.items()}


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded paths on an n_devices mesh (a 'space' axis of 2 when
    n_devices is even): the sharded batch analysis, the banded stencil
    frontend (equal to the unsharded one), `encode_many` and `encode_stream`
    over the mesh (byte-equal to the one-device encode), and the scaling
    summary from this run's own stage profile.  Without `devices` the mesh
    is the first n_devices CUDA cards, and fewer cards raise.  Returns the
    summary it prints."""
    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch.parallel import mesh as M
    from roibasedimagecompression_torch.parallel import scaling as SC
    from roibasedimagecompression_torch.parallel import stream
    from roibasedimagecompression_torch.utils import timing

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip needs {n_devices} CUDA devices but {have} are visible; "
                "pass devices= (for example ['cpu'] * n) for a mesh of repeated devices"
            )
    space = 2 if n_devices % 2 == 0 else 1
    mesh = M.make_mesh(n_devices, space=space, devices=devices)
    dp = n_devices // space

    rng = np.random.default_rng(0)
    batch = dp * 2
    images = rng.integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)

    out = M.sharded_batch_analysis(mesh, images, n_centers_side=4, palette_cap=512, quality=20.0)
    if tuple(out["segments"].shape) != (batch, 64, 64) or not float(out["edge_fraction"]) >= 0.0:
        raise AssertionError("sharded batch analysis gave a malformed result")

    mag, density = M.sharded_stencil_frontend(mesh, images)
    ref_mag, ref_density = M.stencil_frontend(images, device=mesh.first)
    if not (torch.equal(mag, ref_mag) and torch.equal(density, ref_density)):
        raise AssertionError("the banded stencil frontend must equal the unsharded one")

    # The whole codec, data-parallel: every bucketed stage splits its rows
    # over the data devices, a placement decision that changes no byte.
    enc_images = [images[k] for k in range(batch)]
    config = cfg.CodecConfig()
    sharded = stream.encode_many(enc_images, config, mesh=mesh)
    before = _stage_seconds(timing.stage_report())
    unsharded = stream.encode_many(enc_images, config, device=mesh.first)
    after = _stage_seconds(timing.stage_report())
    if not all(isinstance(d, bytes) and d[:5] == b"RHCCQ" for d in sharded):
        raise AssertionError("sharded encode gave no containers")
    if sharded != unsharded:
        raise AssertionError("sharded encode must be byte-identical")

    more = rng.integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)
    batches = [enc_images, [more[k] for k in range(batch)]]
    streamed = stream.encode_stream(batches, config, workers=2, mesh=mesh)
    if streamed[0] != unsharded or streamed[1] != stream.encode_many(batches[1], config, device=mesh.first):
        raise AssertionError("stream-level sharded encode must be byte-identical")

    stages = {k: after[k] - before.get(k, 0.0) for k in after}
    proj = SC.projected_throughput(stages, batch * 64 * 64 / 1e6, n_devices)
    work = SC.shard_work_ratio(mesh, shape=(batch, 64, 64, 3))
    summary = {
        "mesh": mesh.shape,
        "devices": [str(d) for d in mesh.devices.reshape(-1)],
        "batch": batch,
        "edge_fraction": float(out["edge_fraction"]),
        "dp_encode_bytes": [len(d) for d in sharded],
        "profile": {"host_s": proj["host_s"], "device_s": proj["device_s"]},
        "projected": {"single_host_mpps": proj["single_host_mpps"],
                      "host_per_chip_mpps": proj["host_per_chip_mpps"]},
        "per_device_work": work,
    }
    print(
        f"dryrun_multichip OK: mesh={summary['mesh']}, batch={batch}, "
        f"edge_fraction={summary['edge_fraction']:.4f}, dp_encode_bytes={summary['dp_encode_bytes']}, "
        f"measured_profile={{host {proj['host_s']}s + device {proj['device_s']}s per "
        f"{batch * 64 * 64 / 1e6} MP on {mesh.first}}}, projected_{n_devices}chip={{single-host "
        f"{proj['single_host_mpps']} MP/s, host-per-chip {proj['host_per_chip_mpps']} MP/s}}, "
        f"per_device_work={{1dev {work['flops_1dev']:.3g} -> {work['flops_per_dev']:.3g}/dev, "
        f"ratio {work['ratio']}x}}"
    )
    return summary
