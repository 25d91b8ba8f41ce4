"""Device profiling: a torch.profiler trace around a block of work.

The counterpart of the JAX package's `utils/profiling.py`: utils/timing.py
gives host wall-clock per stage, this gives the kernels and copies on the
card (and the host ops) as a Chrome trace, viewable in Perfetto or
chrome://tracing, with the program's stage spans (utils/timing.py, recorded
for the block) on the same clock, each on the row of the thread that ran it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import time

import torch

from roibasedimagecompression_torch.utils import timing

_counter = itertools.count()


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) and write `trace-<pid>-<n>.json` into `log_dir`
    (RHCCQ_TRACE_DIR, else `rhccq_trace` under the temporary directory).
    Yields the profiler; its `trace_path` attribute names the file once the
    block has ended.  Span recording is on inside the block, and the spans
    opened in it are written into the trace (category `stage`; in `args`
    their request id, their index among the written spans and their
    parent's, None where the parent opened before the block).  Where
    recording was off before the block, the block's spans are dropped once
    they have been read, so none is kept.

        with device_trace("traces") as prof:
            rtt.encode(image)
    """
    log_dir = log_dir or os.environ.get("RHCCQ_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "rhccq_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_counter)}.json")
    was = timing.record(True)
    # On the spans' clock (Unix epoch): a reset_spans inside the block
    # moves the indices, not the times.
    t0 = time.time_ns()
    try:
        with prof:
            yield prof
    finally:
        timing.record(was)
        recorded = timing.spans()
        if not was:
            timing.reset_spans()
    prof.export_chrome_trace(prof.trace_path)
    _write_spans(prof.trace_path, recorded, t0)


def _write_spans(path: str, recorded: list, t0: int) -> None:
    """Add the closed spans of `recorded` that opened at or after `t0` (ns)
    to the Chrome trace at `path`: its events' `ts` are microseconds after
    its `baseTimeNanoseconds`, on the clock the spans are stamped with."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    kept = [i for i, s in enumerate(recorded) if s.end is not None and s.start >= t0]
    index = {i: j for j, i in enumerate(kept)}
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "stage", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start - base) / 1e3, "dur": (s.end - s.start) / 1e3,
         "args": {"request": s.request, "id": index[i], "parent": index.get(s.parent)}}
        for i, s in ((i, recorded[i]) for i in kept)
    )
    with open(path, "w") as f:
        json.dump(trace, f)


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
