"""Stage tracing: host wall-clock (and process CPU) per pipeline stage.

One context-manager timer feeds a registry that callers and `chip_smoke.py`
read.  On CUDA a stage's wall time includes the device work only where the
stage itself waits on the device (every stage of the codec ends in a host
copy, so it does).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_STAGES: dict = defaultdict(float)
_CPU: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)


@contextlib.contextmanager
def stage_timer(name: str):
    t0 = time.perf_counter()
    c0 = time.process_time()
    try:
        yield
    finally:
        _STAGES[name] += time.perf_counter() - t0
        _CPU[name] += time.process_time() - c0
        _COUNTS[name] += 1


def reset_stages() -> None:
    _STAGES.clear()
    _CPU.clear()
    _COUNTS.clear()


def stage_report() -> dict:
    return {
        k: {"seconds": v, "cpu_seconds": _CPU[k], "calls": _COUNTS[k]}
        for k, v in sorted(_STAGES.items())
    }
