"""Bucket-call routing: every batched device call of the codec goes through
`submit`.

The counterpart of the JAX package's `utils/dispatch.py`, with one difference
on purpose: every call runs inline, on the caller's thread and on its CUDA
stream, and returns a completed future.  The JAX package hands each
signature's first call to a thread pool because that call compiles an XLA
graph, and concurrent compiles overlap; the port compiles nothing at a new
shape (its kernels are built once per process, which `utils/warmup.py
prewarm` starts ahead of the first encode), and a pool thread would launch on
its own default stream instead of an `encode_stream` worker's.  What stays:
`submit` records the call for a warm-up manifest (`warmup.record_call`), runs
it under the operation count when that is on (`flops.track`), and runs it
shard by shard when an argument is sharded over a mesh (`parallel/shard.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.parallel import shard as SHARD


class _Done:
    """Completed future of an inline call: its value, or the exception it
    raised (re-raised by `result`)."""

    __slots__ = ("_value", "_exc")

    def __init__(self, value=None, exc: BaseException | None = None):
        self._value = value
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout=None):
        return self._exc

    def done(self) -> bool:
        return True


def _arg_key(a):
    if isinstance(a, (np.ndarray, torch.Tensor, SHARD.Sharded)):
        return (tuple(a.shape), str(a.dtype))
    if isinstance(a, np.generic):
        return ("np", str(a.dtype))
    if isinstance(a, (list, dict, set)) or callable(a):
        # Containers and callables do not reduce to a shape signature; keying
        # them by type name would alias different payloads to one key.
        return None
    return ("lit", type(a).__name__)


def _kw_key(v):
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor, SHARD.Sharded)):
        return _arg_key(v)
    return ("val", v)


def _call_key(fn, args, kwargs):
    """The signature of a call (function, argument shapes and dtypes, keyword
    values), or None when an argument has none."""
    arg_keys = tuple(_arg_key(a) for a in args)
    if any(k is None for k in arg_keys):
        return None
    key = (fn, arg_keys, tuple(sorted((k, _kw_key(v)) for k, v in kwargs.items())))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def submit(fn, *args, **kwargs) -> _Done:
    """Run fn(*args, **kwargs) inline; returns a completed future whose
    `result()` is the value (or raises what the call raised)."""
    from roibasedimagecompression_torch.utils import flops, warmup

    warmup.record_call(fn, args, kwargs)
    try:
        return _Done(flops.track(SHARD.call, (fn, args, kwargs), {}))
    except Exception as exc:  # handed to the caller through result()
        return _Done(exc=exc)


def resolve(items):
    """Map a list whose entries may be futures to their results, in order."""
    return [x.result() if hasattr(x, "result") else x for x in items]
