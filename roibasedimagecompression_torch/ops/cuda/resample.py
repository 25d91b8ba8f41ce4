"""SLIC's working-resolution resize on the card (kernel `csrc/resample.cu`).

`resize_many` shrinks RGB uint8 crops the way `PIL.Image.resize(..., BILINEAR)`
does, bit for bit: PIL's antialiased 8-bit resample (libImaging/Resample.c).
The coefficients of an (in, out) size pair are computed on the host in
float64 (`resample_coeffs`), normalised by a sequential sum and rounded to
22-bit integers; the horizontal pass runs first and is rounded and clipped
into uint8, then the vertical pass reads it; each output value is
`clip((2^21 + sum of pixel * weight) >> 22, 0, 255)`.  An axis whose size
does not change gets no pass.

The kernel replaces no Pallas kernel.  The JAX package resizes SLIC's
working images with PIL on the host (its `models/segment.py
region_segments_many`); the port did so in numpy (`models/segment.py
_resize_uint8`, still the CPU's route) and uploaded each result, although
the unscaled crop already lay on the card.  On a CUDA device every row of
one call is resized in one launch, read where it lies (a slice of the
device batch needs no copy).  `resize_plain` is the plain version, the same
arithmetic in int32 PyTorch, which the wrapper takes for CPU tensors.

Coefficient tables are cached per (in, out) on the host (`coeff_table`)
and per device (`_device_table`), so a size pair is computed once a process;
the pairs a process meets are bounded by the sizes of its images.
"""

from __future__ import annotations

import collections
import functools
import math
import threading

import numpy as np
import torch

from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS

PRECISION_BITS = 32 - 8 - 2
_TX, _TY = 32, 16  # the kernel's output tile (csrc kTX, kTY)
_FIELDS = 12       # int64 fields of a row's descriptor (csrc kFields)

_tables: dict = {}  # (in, out, device) -> the (out, 2 + taps) int32 table on the device
_tables_lock = threading.Lock()


def resample_coeffs(in_size: int, out_size: int):
    """(bounds (out, 2) int64 [xmin, count], kk (out, ksize) int64): PIL's
    bilinear coefficients of a resize from in_size to out_size, as 22-bit
    integers, zero past each row's count."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # bilinear filter support
    ksize = int(math.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.float64)
    bounds = np.zeros((out_size, 2), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        wv = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        ww = 0.0
        for v in wv:  # sequential sum, as the C loop
            ww += v
        if ww != 0.0:
            wv = wv / ww
        kk[xx, :xmax] = wv
        bounds[xx] = (xmin, xmax)
    scaled = kk * (1 << PRECISION_BITS)
    kint = np.where(scaled < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5)).astype(np.int64)
    return bounds, kint


@functools.lru_cache(maxsize=None)
def coeff_table(in_size: int, out_size: int) -> np.ndarray:
    """(out, 2 + ksize) int32, read-only: row i is [xmin, count, kk[i]] of
    `resample_coeffs(in_size, out_size)`, computed once a process."""
    bounds, kint = resample_coeffs(in_size, out_size)
    table = np.concatenate([bounds, kint], axis=1).astype(np.int32)
    table.flags.writeable = False
    return table


def _device_table(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    key = (in_size, out_size, device)
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            table = _tables[key] = torch.from_numpy(coeff_table(in_size, out_size).copy()).to(device)
        return table


def _axis_plain(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """One pass along `dim` (0: rows, 1: columns) of an (h, w, 3) int32
    tensor of values in [0, 255]: every tap of the table, past a row's
    count at weight 0 on a clamped index."""
    in_size = x.shape[dim]
    table = coeff_table(in_size, out_size)
    ksize = table.shape[1] - 2
    idx = torch.from_numpy(np.minimum(table[:, :1] + np.arange(ksize), in_size - 1)).to(x.device)
    weights = torch.from_numpy(table[:, 2:].copy()).to(x.device)
    shape = [1, 1, 1]
    shape[dim] = out_size
    out_shape = list(x.shape)
    out_shape[dim] = out_size
    acc = torch.full(out_shape, 1 << (PRECISION_BITS - 1), dtype=torch.int32, device=x.device)
    for t in range(ksize):
        acc += x.index_select(dim, idx[:, t]) * weights[:, t].view(shape)
    return (acc >> PRECISION_BITS).clamp_(0, 255)


def resize_plain(img: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(nh, nw, 3) uint8: the kernel's resize of one (h, w, 3) uint8 image
    to shape = (nh, nw), in int32 PyTorch on the image's device."""
    x = img.to(torch.int32)
    if x.shape[1] != shape[1]:
        x = _axis_plain(x, shape[1], 1)
    if x.shape[0] != shape[0]:
        x = _axis_plain(x, shape[0], 0)
    return x.to(torch.uint8)


def _check(img, device, shape) -> None:
    if not torch.is_tensor(img) or img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        got = (tuple(img.shape), img.dtype) if torch.is_tensor(img) else type(img).__name__
        raise ValueError(f"an image must be (h, w, 3) uint8, got {got}")
    if img.device != device:
        raise ValueError(f"every image must lie on {device}, got one on {img.device}")
    if img.stride(2) != 1 or img.stride(1) != 3 or img.stride(0) < 3 * img.shape[1]:
        raise ValueError(f"an image's rows must hold contiguous pixels, got strides {img.stride()}")
    if img.shape[0] < 1 or img.shape[1] < 1 or len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"need sizes of at least 1, got {tuple(img.shape[:2])} -> {tuple(shape)}")


def resize_many(images: list, shapes: list) -> list:
    """images[i], an (h, w, 3) uint8 tensor whose rows hold contiguous pixels
    (any row pitch: a slice of a larger image will do), resized to shapes[i]
    = (nh, nw): a list of contiguous (nh, nw, 3) uint8 tensors, equal to
    `resize_plain`'s.  Every image lies on one device.  On a CUDA device one
    kernel launch on the current stream for all rows, recorded under the
    sorted ((h, w, nh, nw), rows) counts; on the CPU the plain version."""
    if len(images) != len(shapes):
        raise ValueError(f"{len(images)} images but {len(shapes)} shapes")
    if not images:
        return []
    device = images[0].device if torch.is_tensor(images[0]) else None
    for img, shape in zip(images, shapes):
        _check(img, device, shape)
    shapes = [(int(nh), int(nw)) for nh, nw in shapes]
    if device.type != "cuda":
        return [resize_plain(img, shape) for img, shape in zip(images, shapes)]

    sizes = [nh * nw * 3 for nh, nw in shapes]
    out = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    desc = np.zeros((len(images), _FIELDS), np.int64)
    offset, blocks, macs, nbytes = 0, 0, 0, 0
    for i, (img, (nh, nw)) in enumerate(zip(images, shapes)):
        h, w = img.shape[:2]
        xt = _device_table(w, nw, device) if w != nw else None
        yt = _device_table(h, nh, device) if h != nh else None
        desc[i] = (img.data_ptr(), img.stride(0), h, w, nh, nw, out.data_ptr() + offset,
                   0 if xt is None else xt.data_ptr(), 0 if xt is None else xt.shape[1] - 2,
                   0 if yt is None else yt.data_ptr(), 0 if yt is None else yt.shape[1] - 2, blocks)
        offset += sizes[i]
        blocks += -(-nh // _TY) * -(-nw // _TX)
        if xt is not None:
            macs += 3 * h * int(coeff_table(w, nw)[:, 1].sum())
        if yt is not None:
            macs += 3 * nw * int(coeff_table(h, nh)[:, 1].sum())
        nbytes += 3 * h * w + sizes[i]
    if blocks >= 2**31:
        raise ValueError(f"{blocks} output tiles exceed one launch's grid")
    # Pinned, so the upload queues behind the stream's work without a wait.
    desc_d = torch.from_numpy(desc).pin_memory().to(device, non_blocking=True)
    key = tuple(sorted(collections.Counter(
        (img.shape[0], img.shape[1], nh, nw) for img, (nh, nw) in zip(images, shapes)).items()))
    _build.launch("resample", "resample_launch", device, desc_d.data_ptr(), len(images), blocks, key=key)
    # Two operations an integer multiply-add; each crop read once, each
    # output written once.
    FLOPS.add(2 * macs, nbytes)
    return [part.view(nh, nw, 3) for part, (nh, nw) in zip(out.split(sizes), shapes)]
