"""Row sharding for the batched bucket calls (a leaf module: no model
imports).

The counterpart of the JAX package's `parallel/shard.py`.  Every bucketed
batch of the codec (split-score crops, SLIC regions, eps-CC palette rows,
k-means splits) is independent row by row, so data parallelism is a
placement decision: `shard_rows` splits a padded batch's rows over the
mesh's data devices, and a call given sharded arguments (`call`, through
`utils/dispatch.py call`) runs each chunk on its owner device, with the
other tensor arguments copied there, and gathers the results on the mesh's
first device.  The shards are issued one after another from the calling
thread, on each device's current stream; a call that waits on its device
(a convergence check) finishes its shard before the next starts.
"""

from __future__ import annotations

import numpy as np
import torch


def data_axis_size(mesh) -> int:
    """Size of the mesh's 'data' axis (1 when mesh is None)."""
    if mesh is None:
        return 1
    return int(mesh.shape["data"])


def pad_rows(b: int, mesh) -> int:
    """Round a batch's row count up to a multiple of the data axis, so rows
    shard evenly."""
    d = data_axis_size(mesh)
    return -(-b // d) * d


def pad_to(x, n: int):
    """x (tensor, array or list) with rows repeated from its last up to n
    rows.  The padded rows are valid inputs whose results are dropped (the
    JAX package pads zeros; the rows' own results do not depend on them)."""
    extra = n - len(x)
    if extra <= 0:
        return x
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand(extra, *x.shape[1:])])
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)])
    return list(x) + [x[-1]] * extra


class Sharded:
    """A batch split by rows over a mesh's data devices: `chunks[i]` lives
    on `devices[i]`; `shape` and `dtype` are the whole batch's."""

    def __init__(self, chunks: list, devices: list, shape: tuple, dtype):
        self.chunks, self.devices, self.shape, self.dtype = chunks, devices, shape, dtype


def _to(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


def shard_rows(x, mesh):
    """Split a batch's rows over the mesh's data devices.  The row count must
    already be a multiple of the data axis (`pad_rows`).  With mesh=None, x
    itself: the one-device path."""
    if mesh is None:
        return x
    devices = mesh.data_devices
    n = len(x)
    if n % len(devices):
        raise ValueError(f"{n} rows do not split over {len(devices)} data devices")
    per = n // len(devices)
    chunks = [_to(x[i * per : (i + 1) * per], dev) for i, dev in enumerate(devices)]
    return Sharded(chunks, devices, tuple(x.shape) if hasattr(x, "shape") else (n,),
                   getattr(x, "dtype", None))


def _gather(outs: list, dev):
    first = outs[0]
    if torch.is_tensor(first):
        return torch.cat([o.to(dev) for o in outs])
    if isinstance(first, np.ndarray):
        return np.concatenate(outs)
    if isinstance(first, tuple):
        return tuple(_gather([o[j] for o in outs], dev) for j in range(len(first)))
    if isinstance(first, (int, float)):
        return max(outs)
    raise TypeError(f"cannot gather shard results of type {type(first).__name__}")


def call(fn, args: tuple, kwargs: dict):
    """fn(*args, **kwargs); with sharded arguments, once per shard on its
    owner device (the other tensors copied there), the results gathered on
    the first device: tensors and arrays concatenated by rows, counts by
    their maximum."""
    sharded = [a for a in list(args) + list(kwargs.values()) if isinstance(a, Sharded)]
    if not sharded:
        return fn(*args, **kwargs)
    devices = sharded[0].devices
    outs = []
    for i, dev in enumerate(devices):
        def pick(a):
            return a.chunks[i] if isinstance(a, Sharded) else _to(a, dev)

        outs.append(fn(*[pick(a) for a in args], **{k: pick(v) for k, v in kwargs.items()}))
    return _gather(outs, devices[0])


def collect_all(results) -> list:
    """Download a list of tensors with one wait per device: every copy to
    host starts first (non-blocking, into pinned memory on CUDA), then each
    device's stream is synchronised once.  Arrays pass through; returns
    numpy arrays in order."""
    started, devices = [], set()
    for r in results:
        if torch.is_tensor(r) and r.device.type == "cuda":
            buf = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
            buf.copy_(r, non_blocking=True)
            devices.add(r.device)
            started.append(buf)
        else:
            started.append(r)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return [r.numpy() if torch.is_tensor(r) else np.asarray(r) for r in started]
