"""Warm-up before the first encode of a process: build `_build/`, replay a
manifest.

The counterpart of the JAX package's `utils/warmup.py`, whose first-use cost
is a wave of XLA compiles and whose manifest (`warm_manifest.json`) replays
them in parallel.  The port's first-use cost is building its libraries: the
CUDA kernels (nvcc, `ops/cuda/_build.py`) and the native host runtime
(g++).  So:

  1. RECORD: with RHCCQ_RECORD_MANIFEST set (or `enable_recording()`), every
     bucket call that goes through `utils/dispatch.py call` logs (function,
     argument shapes and dtypes, literal arguments); `save` writes the
     deduplicated manifest.
  2. PREWARM: `prewarm` builds `_build/` (the kernels on a CUDA device, and
     the runtime unless RHCCQ_NATIVE=0), then replays a manifest's entries
     with zero inputs on the device, which loads every library and touches
     each call's allocations once.  With block=False it runs on a thread and
     returns its future: a build failure is kept there, and the first encode
     that needs the library raises it again.

`source_fingerprint` hashes the port's sources; `check_pack_freshness` says
whether `_build/` holds the libraries of the current sources.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import threading

import numpy as np
import torch

_entries: list = []
_seen: set = set()
_lock = threading.Lock()
_recording = os.environ.get("RHCCQ_RECORD_MANIFEST", "") not in ("", "0")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_recording() -> None:
    global _recording
    _recording = True


def _arg_spec(a):
    from roibasedimagecompression_torch.parallel import shard as SHARD

    if isinstance(a, (torch.Tensor, SHARD.Sharded)):
        return {"t": "arr", "shape": list(a.shape), "dtype": str(a.dtype).replace("torch.", "")}
    if isinstance(a, np.ndarray):
        return {"t": "arr", "shape": list(a.shape), "dtype": str(a.dtype), "np": True}
    if isinstance(a, bool) or isinstance(a, (int, float, str)) or a is None:
        return {"t": "lit", "v": a}
    if isinstance(a, np.generic):
        return {"t": "np", "dtype": str(a.dtype), "v": a.item()}
    return None


def record_call(fn, args, kwargs) -> None:
    """Log one bucket call's signature (no-op unless recording)."""
    if not _recording:
        return
    mod, qual = getattr(fn, "__module__", None), getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual:
        return  # lambdas and local functions are not replayable
    spec = {"fn": f"{mod}:{qual}", "args": [], "kwargs": {}}
    for a in args:
        s = _arg_spec(a)
        if s is None:
            return
        spec["args"].append(s)
    for k, v in kwargs.items():
        s = _arg_spec(v)
        if s is None:
            return
        spec["kwargs"][k] = s
    key = json.dumps(spec, sort_keys=True)
    with _lock:
        if key not in _seen:
            _seen.add(key)
            _entries.append(spec)


def save(path: str) -> int:
    """Write the recorded manifest; returns the entry count."""
    with _lock:
        with open(path, "w") as f:
            json.dump(_entries, f, indent=0)
        return len(_entries)


def _build(spec, device=None):
    """A zero-filled argument from its spec (a tensor on `device`)."""
    if spec["t"] == "arr":
        if spec.get("np"):
            return np.zeros(tuple(spec["shape"]), np.dtype(spec["dtype"]))
        return torch.zeros(tuple(spec["shape"]), dtype=getattr(torch, spec["dtype"]), device=device)
    if spec["t"] == "np":
        return np.dtype(spec["dtype"]).type(spec["v"])
    return spec["v"]


def _resolve(name: str):
    import importlib

    mod, qual = name.split(":", 1)
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _prewarm(path, device) -> int:
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build as KB

    if device.type == "cuda":
        KB.prebuild()
    if native.available():
        native.get_lib()
    if path is None:
        return 0
    with open(path) as f:
        entries = json.load(f)
    for e in entries:
        fn = _resolve(e["fn"])
        fn(*[_build(s, device) for s in e["args"]],
           **{k: _build(s, device) for k, s in e["kwargs"].items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return len(entries)


def prewarm(path: str | None = None, block: bool = False, device=None):
    """Build `_build/` for `device` (CUDA when None) and replay the manifest
    at `path`, if any, with zero inputs.  block=True returns the number of
    entries replayed; otherwise a future of it, on a thread of its own.  A
    failure raises (block=True) or is kept in the future."""
    from roibasedimagecompression_torch.utils import device as DEV

    dev = DEV.resolve(device)
    if block:
        return _prewarm(path, dev)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="rhccq-prewarm")
    try:
        return pool.submit(_prewarm, path, dev)
    finally:
        pool.shutdown(wait=False)


def source_fingerprint() -> str:
    """sha256 (16 hex digits) over the port's sources that its builds and
    kernels come from: every .py, .cu and .cpp file of the package, in
    sorted order of their paths relative to the package."""
    import hashlib

    files = []
    for d, _, fs in os.walk(_PKG):
        if os.path.basename(d) == "_build":
            continue
        files += [os.path.join(d, f) for f in fs if f.endswith((".py", ".cu", ".cpp"))]
    h = hashlib.sha256()
    for p in sorted(files, key=lambda p: os.path.relpath(p, _PKG)):
        h.update(os.path.relpath(p, _PKG).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def check_pack_freshness(log=print) -> bool:
    """Whether `_build/` holds the libraries of the current sources: the
    native runtime (unless RHCCQ_NATIVE=0) and every kernel library under
    the current nvcc's build keys.  Logs what is missing."""
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build as KB

    missing = []
    if native.available() and not os.path.exists(native.lib_path()):
        missing.append(os.path.basename(native.lib_path()))
    try:
        paths = [KB.lib_path(name) for name in KB.KERNELS]
    except RuntimeError as exc:  # no nvcc: the kernels cannot be keyed here
        log(f"build pack: kernels not checked ({exc})")
        return False
    missing += [os.path.basename(p) for p in paths if not os.path.exists(p)]
    if missing:
        log("build pack is missing " + ", ".join(missing) + " (prewarm builds them)")
        return False
    return True
