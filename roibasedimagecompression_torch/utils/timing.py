"""Stage tracing: host wall-clock (and process CPU) per pipeline stage.

One context-manager timer feeds a registry that callers and `chip_smoke.py`
read.  On CUDA a stage's wall time includes the device work only where the
stage itself waits on the device (every stage of the codec ends in a host
copy, so it does).  The registry is shared by the threads of `encode_stream`
and guarded by a lock; stages that overlap in time each add their own wall
seconds.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_STAGES: dict = defaultdict(float)
_CPU: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)
_LOCK = threading.Lock()


@contextlib.contextmanager
def stage_timer(name: str):
    t0 = time.perf_counter()
    c0 = time.process_time()
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        with _LOCK:
            _STAGES[name] += wall
            _CPU[name] += cpu
            _COUNTS[name] += 1


def reset_stages() -> None:
    with _LOCK:
        _STAGES.clear()
        _CPU.clear()
        _COUNTS.clear()


def stage_report() -> dict:
    with _LOCK:
        return {
            k: {"seconds": v, "cpu_seconds": _CPU[k], "calls": _COUNTS[k]}
            for k, v in sorted(_STAGES.items())
        }
