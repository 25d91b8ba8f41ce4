"""Multi-device scaling: device meshes, the sharded batch analysis, the
spatially partitioned stencil frontend.

The counterpart of the JAX package's `parallel/mesh.py`.  A `Mesh` is a
(data, space) grid of torch devices with the JAX axis names:

  - data parallelism: independent images (or bucket rows, through
    `parallel/shard.py`) split over the 'data' axis, each shard on its
    owner device (`data_devices`: the first device of each data row);
  - spatial partitioning: the stencil frontend (Sobel, the box density)
    runs in row bands over the 'space' axis, each band with a halo of the
    stencils' reach, cropped after; the result equals the unsharded one.

A device may repeat in a mesh, as JAX's virtual CPU mesh repeats one core:
the CPU tests pass ["cpu"] * n, a one-card run ["cuda:0"] * 2.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from roibasedimagecompression_torch.models import pipeline_jit
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.ops import conv as CONV

# Rows of context a band needs on each side: the Sobel (radius 1) feeding
# the 15 x 15 box density (radius 7).
_SOBEL_REACH = 1
_DENSITY_REACH = _SOBEL_REACH + 7


class Mesh:
    """A (data, space) grid of torch devices."""

    axis_names = ("data", "space")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list:
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    @property
    def first(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _check(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev} is not available: no CUDA card")
        if (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is not available: {torch.cuda.device_count()} card(s)")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported mesh device {dev}")
    return dev


def make_mesh(n_devices: int | None = None, space: int = 1, devices=None) -> Mesh:
    """A (data, space) mesh over the first n_devices CUDA cards, or over the
    first n_devices entries of `devices` (torch devices or their names; an
    entry may repeat).  Raises when a device does not exist or there are
    fewer than n_devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs CUDA cards (or pass devices=, e.g. ['cpu'] * n)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_check(torch.device(d)) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise RuntimeError(f"make_mesh needs {n_devices} devices, {len(devices)} are available")
    if n_devices % space != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by space {space}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(n_devices // space, space))


def sharded_batch_analysis(mesh: Mesh, images: np.ndarray, **kw) -> dict:
    """The device encoder core over a batch split on the 'data' axis: each
    data shard's images run `pipeline_jit.batched_analysis_step` on their
    owner device; the outputs are gathered on the mesh's first device, with
    `edge_fraction`, the mean edge coverage of the whole batch (float32).
    images: (B, h, w, 3) uint8, B divisible by the data axis."""
    images = np.asarray(images, np.uint8)
    n_data = mesh.shape["data"]
    if len(images) % n_data:
        raise ValueError(f"batch {len(images)} does not split over {n_data} data devices")
    per = len(images) // n_data
    parts = [pipeline_jit.batched_analysis_step(images[i * per : (i + 1) * per], device=dev, **kw)
             for i, dev in enumerate(mesh.data_devices)]
    out = {k: torch.cat([p[k].to(mesh.first) for p in parts]) for k in parts[0]}
    edges = out["edges"]
    out["edge_fraction"] = edges.sum(dtype=torch.float64).float() / float(edges.numel())
    return out


def _frontend(images: torch.Tensor):
    """(B, h, w, 3) uint8 -> (L1 Sobel magnitude of the gray image, 15 x 15
    density of the magnitude above 64), both (B, h, w) float32."""
    gray = COL.rgb_to_gray_cv2(images).float()
    gx, gy = CONV.sobel_cv2(gray)
    mag = gx.abs() + gy.abs()
    density = torch.stack([CONV.box_density(m > 64.0, 15) for m in mag])
    return mag, density


def _bands(h: int, n: int) -> list:
    """[(r0, r1)] row bands of an h-row image over n space devices."""
    per = -(-h // n)
    return [(min(h, i * per), min(h, (i + 1) * per)) for i in range(n)]


def sharded_stencil_frontend(mesh: Mesh, images: np.ndarray):
    """The conv frontend (gradient magnitude and local density) with the
    batch over 'data' and image rows over 'space': each band runs on its
    device with a halo of the stencils' reach (the image's own border where
    the band touches it), then the halo is cropped.  Equal to the unsharded
    frontend.  Returns (mag, density), (B, h, w) float32 on the first
    device."""
    images = np.asarray(images, np.uint8)
    b, h = images.shape[:2]
    n_data, n_space = mesh.devices.shape
    if b % n_data:
        raise ValueError(f"batch {b} does not split over {n_data} data devices")
    per = b // n_data
    mags, dens = [], []
    for i in range(n_data):
        rows_m, rows_d = [], []
        for j, (r0, r1) in enumerate(_bands(h, n_space)):
            if r0 == r1:
                continue
            dev = mesh.devices[i, j]
            lo, hi = max(0, r0 - _DENSITY_REACH), min(h, r1 + _DENSITY_REACH)
            band = torch.from_numpy(np.ascontiguousarray(images[i * per : (i + 1) * per, lo:hi])).to(dev)
            mag, density = _frontend(band)
            rows_m.append(mag[:, r0 - lo : r1 - lo].to(mesh.first))
            rows_d.append(density[:, r0 - lo : r1 - lo].to(mesh.first))
        mags.append(torch.cat(rows_m, dim=1))
        dens.append(torch.cat(rows_d, dim=1))
    return torch.cat(mags), torch.cat(dens)


def stencil_frontend(images: np.ndarray, device=None):
    """The same frontend unsharded, on one device (the reference of the
    banded one)."""
    from roibasedimagecompression_torch.utils import device as DEV

    return _frontend(torch.from_numpy(np.asarray(images, np.uint8)).to(DEV.resolve(device)))


def data_parallel_encode_throughput(mesh: Mesh, images: np.ndarray, repeats: int = 3):
    """Timed data-parallel runs of the device core; returns
    (seconds_per_batch, out), each run ending in a device synchronisation."""
    def sync():
        for dev in {d for d in mesh.devices.reshape(-1) if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    out = sharded_batch_analysis(mesh, images)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = sharded_batch_analysis(mesh, images)
        sync()
    return (time.perf_counter() - t0) / repeats, out
