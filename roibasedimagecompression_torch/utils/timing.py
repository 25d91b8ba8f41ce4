"""Stage tracing: host wall clock per pipeline stage, counters, and spans.

Always on: `stage_timer(name)` adds its wall seconds and one call to a
registry (`stage_report`), and `count(name, n)` adds to a counter registry
beside it (`counters`); `reset_stages` clears both.  On CUDA a stage's wall
time includes the device work only where the stage itself waits on the
device (every stage of the codec ends in a host copy, so it does).  The
registries are shared by the threads of `encode_stream` and guarded by a
lock; stages that overlap in time each add their own wall seconds.

Recording (`record(True)`, off by default): each `stage_timer` also appends
one span to an in-memory list (`spans()`, cleared by `reset_spans`).  A span
holds its name, start and end in nanoseconds on the clock of
`torch.profiler`'s events (Unix epoch: a `perf_counter_ns` reading plus the
offset taken when recording starts), the index of the innermost span open
around it on the same logical call (`parent`), the id of the request it
belongs to and the thread's native id.  `request(name)` opens the root span
of one call of an entry point with a fresh id; a thread pool carries no
context, so work handed to another thread goes through `carry(fn)`, which
runs it inside the caller's open span and request.  With recording off a
stage costs two clock reads and one locked add, and keeps nothing else.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

_STAGES: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)
_COUNTERS: dict = defaultdict(int)
_LOCK = threading.Lock()

_RECORDING = False
_OFFSET_NS = 0  # profiler clock minus perf_counter_ns, taken when recording starts
_SPANS: list = []  # [name, start, end, parent, request, thread]; a span's id is its index
_EPOCH = 0  # bumped by reset_spans, so a span opened before it parents nothing after it
_REQUEST_IDS = itertools.count(1)
# Per thread, `cur`: (epoch, index, request) of the innermost open span, and
# `tid`: its native id (a system call each time it is asked for).
_LOCAL = threading.local()


class Span(NamedTuple):
    name: str
    start: int  # ns, profiler clock
    end: int | None  # None while the span is open
    parent: int | None  # index in spans() of the innermost span around it
    request: int | None
    thread: int  # threading.get_native_id() of the thread that ran it


def _add(name: str, ns: int) -> None:
    with _LOCK:
        _STAGES[name] += ns / 1e9
        _COUNTS[name] += 1


def _open(name: str, t0: int, new_request: bool) -> tuple:
    """Append an open span started at perf_counter_ns `t0` and make it the
    thread's innermost; returns (its record, the thread's previous `cur`)."""
    prev = getattr(_LOCAL, "cur", None)
    tid = getattr(_LOCAL, "tid", None)
    if tid is None:
        tid = _LOCAL.tid = threading.get_native_id()
    with _LOCK:
        parent = prev[1] if prev is not None and prev[0] == _EPOCH else None
        req = next(_REQUEST_IDS) if new_request else (prev[2] if prev is not None else None)
        rec = [name, t0 + _OFFSET_NS, None, parent, req, tid]
        _SPANS.append(rec)
        _LOCAL.cur = (_EPOCH, len(_SPANS) - 1, req)
    return rec, prev


@contextlib.contextmanager
def stage_timer(name: str):
    t0 = time.perf_counter_ns()
    if not _RECORDING:
        try:
            yield
        finally:
            _add(name, time.perf_counter_ns() - t0)
        return
    rec, prev = _open(name, t0, new_request=False)
    try:
        yield
    finally:
        ns = time.perf_counter_ns() - t0
        rec[2] = rec[1] + ns
        _LOCAL.cur = prev
        _add(name, ns)


@contextlib.contextmanager
def request(name: str):
    """Root span of one call of an entry point (`encode`, `encode_many`,
    `encode_stream`), with a fresh request id.  Inside another request (a
    nested entry point, or work carried from one) and with recording off it
    does nothing.  Its time goes to no stage."""
    cur = getattr(_LOCAL, "cur", None)
    if not _RECORDING or (cur is not None and cur[2] is not None):
        yield
        return
    t0 = time.perf_counter_ns()
    rec, prev = _open(name, t0, new_request=True)
    try:
        yield
    finally:
        rec[2] = rec[1] + time.perf_counter_ns() - t0
        _LOCAL.cur = prev


def carry(fn):
    """`fn` wrapped to run, on whatever thread calls it, inside the calling
    thread's innermost open span and request; `fn` itself when recording is
    off or nothing is open."""
    cur = getattr(_LOCAL, "cur", None)
    if not _RECORDING or cur is None:
        return fn

    def carried(*args, **kwargs):
        prev = getattr(_LOCAL, "cur", None)
        _LOCAL.cur = cur
        try:
            return fn(*args, **kwargs)
        finally:
            _LOCAL.cur = prev

    return carried


def record(on: bool) -> bool:
    """Turn span recording on or off; returns whether it was on.  Turning it
    on takes the offset from `perf_counter_ns` to the profiler's clock."""
    global _RECORDING, _OFFSET_NS
    was = _RECORDING
    if on and not was:
        _OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _RECORDING = bool(on)
    return was


def spans() -> list:
    """The recorded spans (`Span`), in the order they were opened."""
    with _LOCK:
        return [Span(*r) for r in _SPANS]


def reset_spans() -> None:
    global _EPOCH
    with _LOCK:
        _SPANS.clear()
        _EPOCH += 1


def self_times(recorded: list) -> list:
    """Each span's duration minus the part of it that its children cover
    (their union: children on other threads may overlap); None for a span
    still open."""
    children = defaultdict(list)
    for s in recorded:
        if s.parent is not None and s.end is not None:
            children[s.parent].append((s.start, s.end))
    out = []
    for i, s in enumerate(recorded):
        if s.end is None:
            out.append(None)
            continue
        covered, edge = 0, s.start
        for lo, hi in sorted(children[i]):
            lo, hi = max(lo, edge), min(hi, s.end)
            if hi > lo:
                covered += hi - lo
                edge = hi
        out.append(s.end - s.start - covered)
    return out


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] += n


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def reset_stages() -> None:
    with _LOCK:
        _STAGES.clear()
        _COUNTS.clear()
        _COUNTERS.clear()


def stage_report() -> dict:
    with _LOCK:
        return {k: {"seconds": v, "calls": _COUNTS[k]} for k, v in sorted(_STAGES.items())}
