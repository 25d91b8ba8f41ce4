"""Executed-operation accounting, for the share of the card's peak an encode
reaches.

The counterpart of the JAX package's `utils/flops.py`, which sums XLA's cost
analysis of every jitted call.  Here, when accounting is on (RHCCQ_MFU=1 or
`enable()`), `track` runs a call under a counting mode and adds what it
executed:

  - matrix products and convolutions by `torch.utils.flop_counter.
    FlopCounterMode`'s formulas (two operations a multiply-add);
  - elementwise ops (ATen's pointwise tag) at one operation per output
    element, reductions (sum, mean, prod, amax, amin, max, min, argmax,
    argmin, any, all) at one per input element;
  - the bytes every counted op reads and writes;
  - the two hand kernels, which run outside PyTorch's dispatcher, by their
    own formulas (`add`, called by their wrappers): kernel 1 `slic_assign` 17
    operations a (pixel, centre) pair in its direct form and 15 in its
    expanded form, kernel 2 `eps_components` 12 operations a valid pair of
    its group a round.

Neither counts sorts, scans (cumsum), gathers, scatters, indexing, copies,
casts other than as elementwise ops, comparisons of whole tensors
(torch.equal), nor host work (numpy, the native runtime, DEFLATE).  An
accounting pass of `chip_smoke.py` divides the total by the wall time and by
H100_PEAK_F32.  Accounting is off in timed passes: the counting mode slows
every op.
"""

from __future__ import annotations

import os
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_lock = threading.Lock()
_local = threading.local()
_enabled = os.environ.get("RHCCQ_MFU", "") not in ("", "0")
_total_flops = 0.0
_total_bytes = 0.0

# One NVIDIA H100 SXM, float32 outside the tensor cores (NVIDIA's data
# sheet, at the 700 W power limit): the port pins float32 everywhere.
H100_PEAK_F32 = 67e12

_REDUCTIONS = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin", "any", "all",
}


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    global _total_flops, _total_bytes
    with _lock:
        _total_flops = 0.0
        _total_bytes = 0.0


def totals() -> tuple:
    """(executed operations, bytes read and written by the counted ops)."""
    return _total_flops, _total_bytes


def add(flops: float, nbytes: float = 0.0) -> None:
    """Add work counted by its own formula (the hand kernels); no-op when
    accounting is off."""
    global _total_flops, _total_bytes
    if not _enabled:
        return
    with _lock:
        _total_flops += float(flops)
        _total_bytes += float(nbytes)


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


class _Elementwise(TorchDispatchMode):
    """Counts elementwise and reduction ops and the bytes of every op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors(args), _tensors(out)
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif func.overloadpacket.__name__ in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        return out


def track(fn, args, kwargs):
    """Run fn(*args, **kwargs) and return its result; when accounting is on,
    add the operations and bytes it executed (a call inside another tracked
    call is counted once, by the outer one)."""
    if not _enabled or getattr(_local, "depth", 0):
        return fn(*args, **kwargs)
    _local.depth = 1
    try:
        with FlopCounterMode(display=False) as mm, _Elementwise() as ew:
            out = fn(*args, **kwargs)
    finally:
        _local.depth = 0
    add(mm.get_total_flops() + ew.flops, ew.bytes)
    return out
