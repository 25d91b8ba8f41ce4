"""Closed loop, one client: the next request starts when the previous
answer is back.  Every request started before the window closes is run to
its end and counted, so the window's work is whole requests."""

from __future__ import annotations

import time
import traceback


def drive(call, requests, seconds: float) -> tuple:
    """Run `requests` (an iterator of (ids, images)) through `call` for
    `seconds`.  Returns (window start, list of request records)."""
    done = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for ids, images in requests:
        start = time.perf_counter()
        if start >= deadline:
            break
        answers, error = None, None
        try:
            answers = call(images)
        except Exception:  # a failed request is counted, and the loop goes on
            error = traceback.format_exc(limit=3)
        done.append({"ids": ids, "start": start, "end": time.perf_counter(),
                     "answers": answers, "error": error})
    return t0, done
