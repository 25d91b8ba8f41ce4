"""Device profiling: a torch.profiler trace around a block of work.

The counterpart of the JAX package's `utils/profiling.py`: utils/timing.py
gives host wall-clock per stage, this gives the kernels and copies on the
card (and the host ops) as a Chrome trace, viewable in Perfetto or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile

import torch

_counter = itertools.count()


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) and write `trace-<pid>-<n>.json` into `log_dir`
    (RHCCQ_TRACE_DIR, else `rhccq_trace` under the temporary directory).
    Yields the profiler; its `trace_path` attribute names the file once the
    block has ended.

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
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
