#!/usr/bin/env python3
"""The program's spans (`utils/timing.py`) against the benchmark's slice:
reductions, and one run of a cell with span recording on.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs `run.py`'s set-up, window, slice and check unchanged, with recording
turned on where the window starts (the window's `reset_stages`) and kept on
through the slice, and logs on standard error:

- `portbench: kmeans by tier`: the window's `epscc.kmeans` spans split by
  the tier stage above them (`s.tier1` / `tier1`, `s.tier23` / `tier23`),
  in ms per image, beside `kmeans_ms` (their stage sum);
- `portbench: kmeans idle`: the share of the union of the slice's
  `kmeans.seed` and `kmeans.lloyd` spans in which no kernel, copy or set ran;
- `portbench: idle by span`: the slice's device-idle seconds put down to the
  innermost span that covers them ("outside spans" where none does), top 10;
- `portbench: coverage`: the share of the slice's device-busy time inside a
  request's top-level stage spans, and how far each such stage's first and
  last device operations lie inside it, which bounds the offset between
  the two clocks (`coverage`);
- `portbench: slowest`: the window's three slowest requests, by first image
  id, with each top-level stage's time and the largest self times of the
  request's spans.

The last line of standard output is `run.py`'s result with these readings
under `spans`.  With `--trace 0` the window's `encode_mpix_per_s` is the
rate with recording on; compare it with `run.py` on the same seeds.  The
benchmark's own runs never record.

`traced_run` reaches into `run.run` through three seams, each a call that
`run.py` makes through its module at call time: `timing.reset_stages()`
(the window starts), `TR.profile_slice(...)` (the slice) and
`H.check_answers(...)` (the window's records).  It swaps these module
attributes for the run.  A `run.py` that bound any of them by name
(`from portbench.trace import profile_slice`) would run unrecorded;
`tests/test_portbench_spans.py` checks each seam.  Once `run.py` itself
turns recording on for `--trace 1` and hands the spans to its readers,
`traced_run` and `main` go, and the reductions above stay.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness as H  # noqa: E402
from portbench import run as RUN  # noqa: E402  (its clock starts here, before torch loads)
from portbench import trace as TR  # noqa: E402

TIERS = {"tier1": ("s.tier1", "tier1"), "tier23": ("s.tier23", "tier23")}
ROOTS = ("encode", "encode_many", "encode_stream")


class Device:
    """The slice's device intervals ((start, end, name), seconds on the
    profiler's clock), sorted by start.  Every length below is the length
    of a union as `trace.busy_seconds` (`device_idle_pct`'s arithmetic)
    computes it."""

    def __init__(self, device: list):
        self.ops = sorted(device)
        self.starts = [lo for lo, _, _ in self.ops]
        self.longest = max((hi - lo for lo, hi, _ in self.ops), default=0.0)
        self.busy = TR.busy_seconds(self.ops)

    def near(self, lo: float, hi: float) -> list:
        """The operations that may meet [lo, hi]."""
        return self.ops[bisect.bisect_left(self.starts, lo - self.longest):
                        bisect.bisect_right(self.starts, hi)]

    def idle(self, intervals: list) -> float:
        """Seconds of the union of `intervals` ((lo, hi) pairs) in which no
        operation ran: its union with the operations near it, less theirs."""
        if not intervals:
            return 0.0
        near = self.near(min(lo for lo, _ in intervals), max(hi for _, hi in intervals))
        return TR.busy_seconds([(lo, hi, "") for lo, hi in intervals] + near) - TR.busy_seconds(near)


def length(intervals) -> float:
    """Length of the union of (lo, hi) intervals."""
    return TR.busy_seconds([(lo, hi, "") for lo, hi in intervals])


def closed(spans: list) -> list:
    """(index, span) of every span that has ended."""
    return [(i, s) for i, s in enumerate(spans) if s.end is not None]


def _seconds(s) -> tuple:
    return s.start / 1e9, s.end / 1e9


def ancestors(spans: list, i: int) -> list:
    out = []
    while spans[i].parent is not None:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def kmeans_by_tier(spans: list) -> dict:
    """Seconds of `epscc.kmeans` spans by the tier stage above them;
    `other` holds any opened outside both tiers."""
    out = {"tier1": 0.0, "tier23": 0.0, "other": 0.0}
    for i, s in closed(spans):
        if s.name != "epscc.kmeans":
            continue
        above = set(ancestors(spans, i))
        tier = next((t for t, names in TIERS.items() if above & set(names)), "other")
        out[tier] += (s.end - s.start) / 1e9
    return out


def idle_share_within(spans: list, names, dev: Device) -> float | None:
    """% of the union of the spans named `names` in which no device
    interval ran."""
    inside = [_seconds(s) for _, s in closed(spans) if s.name in names]
    total = length(inside)
    return 100.0 * dev.idle(inside) / total if total > 0 else None


def idle_by_span(spans: list, dev: Device, window: tuple, n: int = 10) -> list:
    """[[name, seconds], ...]: the device-idle time of `window` ((lo, hi),
    seconds), each part put down to the innermost span open over it (a
    span's idle time less the part its children cover; "outside spans"
    where none is open), summed by name, the n largest."""
    children = defaultdict(list)
    for _, s in closed(spans):
        if s.parent is not None:
            children[s.parent].append(_seconds(s))

    def clipped(intervals, lo, hi):
        return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]

    total: dict = defaultdict(float)
    for i, s in closed(spans):
        lo, hi = _seconds(s)
        total[s.name] += dev.idle([(lo, hi)]) - dev.idle(clipped(children[i], lo, hi))
    roots = clipped([_seconds(s) for _, s in closed(spans) if s.parent is None], *window)
    total["outside spans"] = dev.idle([window]) - dev.idle(roots)
    ranked = sorted(((k, v) for k, v in total.items() if v > 1e-9), key=lambda kv: -kv[1])
    return [[name, secs] for name, secs in ranked[:n]]


def top_level(spans: list) -> list:
    """(index, span) of the closed stages directly under a request's root."""
    roots = {i for i, s in enumerate(spans) if s.name in ROOTS and s.parent is None}
    return [(i, s) for i, s in closed(spans) if s.parent in roots]


def coverage(spans: list, dev: Device) -> dict:
    """`busy_in_stages_pct`: % of the device-busy time inside top-level stage
    spans.  Of the device operations that start inside such a stage,
    `start_lead_ms`: from the stage's start to the first one's start, and
    `end_lag_ms`: from the last one's end to the stage's end (min and
    median over the stages).  Spans late on the device's clock by d move
    every lead down by d and every lag up by d: with both minima at or
    above 0, d lies between -(least lag) and +(least lead)."""
    stages = [_seconds(s) for _, s in top_level(spans)]
    inside = length(stages) - dev.idle(stages)
    leads, lags = [], []
    for lo, hi in stages:
        a, b = bisect.bisect_left(dev.starts, lo), bisect.bisect_right(dev.starts, hi)
        if b > a:
            leads.append(1e3 * (dev.starts[a] - lo))
            lags.append(1e3 * (hi - max(end for _, end, _ in dev.ops[a:b])))

    def spread(xs):
        xs = sorted(xs)
        return {"min": xs[0], "median": xs[len(xs) // 2]} if xs else None

    return {"busy_in_stages_pct": 100.0 * inside / dev.busy if dev.busy > 0 else None,
            "stages": len(stages), "start_lead_ms": spread(leads), "end_lag_ms": spread(lags)}


def request_stages(spans: list, n_self: int = 5) -> list:
    """One entry per request root, in the order they opened: its id, wall
    seconds, each top-level stage's seconds (summed by name), and the
    `n_self` largest self times of its spans (summed by name; the root's
    own is the time outside every stage)."""
    from roibasedimagecompression_torch.utils import timing

    selfs = timing.self_times(spans)
    out, where = [], {}
    for i, s in closed(spans):
        if s.name in ROOTS and s.parent is None:
            where[s.request] = len(out)
            out.append({"request": s.request, "seconds": (s.end - s.start) / 1e9, "stages": {},
                        "self": defaultdict(float)})
    roots = {i for i, s in enumerate(spans) if s.name in ROOTS and s.parent is None}
    for i, s in closed(spans):
        if s.request not in where:
            continue
        entry = out[where[s.request]]
        entry["self"][s.name] += selfs[i] / 1e9
        if s.parent in roots:
            entry["stages"][s.name] = entry["stages"].get(s.name, 0.0) + (s.end - s.start) / 1e9
    for entry in out:
        entry["self"] = dict(sorted(entry["self"].items(), key=lambda kv: -kv[1])[:n_self])
    return out


def report(spans: list, first: int, window_records: list, images: int, trace, window) -> dict:
    """The readings above from a run's spans: those before index `first`
    are the window's, the rest the slice's (`trace`, whose host window on
    the profiler's clock is `window`, in seconds)."""
    t0 = time.perf_counter()
    out = {"kmeans_ms_by_tier": {k: 1e3 * v / max(images, 1)
                                 for k, v in kmeans_by_tier(spans[:first]).items()}}
    requests = request_stages(spans[:first])
    if len(requests) == len(window_records):
        for req, rec in zip(requests, window_records):
            req["first_id"] = rec["ids"][0]
    out["slowest"] = sorted(requests, key=lambda r: -r["seconds"])[:3]
    if trace is not None:
        sliced = [s._replace(parent=None if s.parent is None or s.parent < first
                             else s.parent - first) for s in spans[first:]]
        dev = Device(trace.device)
        out["kmeans_idle_pct"] = idle_share_within(sliced, ("kmeans.seed", "kmeans.lloyd"), dev)
        out["idle_by_span"] = idle_by_span(sliced, dev, window)
        out["coverage"] = coverage(sliced, dev)
    out["reduction_s"] = time.perf_counter() - t0
    return out


def traced_run(args, device: str = "cuda", bench: dict | None = None, t_start=None) -> dict:
    """`run.py`'s run of `args` with span recording on from the window's
    start; its result, with the readings under `spans`."""
    from roibasedimagecompression_torch.utils import timing

    seen = {}
    reset_stages, profile_slice, check_answers = timing.reset_stages, TR.profile_slice, H.check_answers

    def window_starts():
        reset_stages()
        timing.reset_spans()
        timing.record(True)

    def traced(fn):
        seen["slice"] = len(timing.spans())

        def stamped():
            seen["slice_t0"] = time.time_ns() / 1e9
            return fn()

        sl = profile_slice(stamped)
        timing.record(False)
        seen["trace"] = sl
        return sl

    def judged(records, *a, **k):
        seen["records"] = records
        return check_answers(records, *a, **k)

    timing.reset_stages, TR.profile_slice, H.check_answers = window_starts, traced, judged
    try:
        result = RUN.run(args, device=device, t_start=t_start or RUN.T_START, bench=bench)
    finally:
        timing.reset_stages, TR.profile_slice, H.check_answers = reset_stages, profile_slice, check_answers
        timing.record(False)
    spans = timing.spans()
    window_records = [r for r in seen.get("records", []) if r.get("in_window")]
    sl = seen.get("trace")
    result["spans"] = report(spans, seen.get("slice", len(spans)), window_records,
                             sum(len(r["ids"]) for r in window_records), sl,
                             (seen["slice_t0"], seen["slice_t0"] + sl.window_s) if sl else None)
    result["spans"]["n_spans"] = len(spans)
    return result


def main(argv=None) -> int:
    import torch

    args = RUN.parse_args(argv)
    RUN.prepare_environment()
    cell = H.resolve(H.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        RUN.log(f"portbench: needs {cell.chips} CUDA device(s): no result")
        return 3
    RUN.log(f"portbench: card {RUN.card_line()}; torch {torch.__version__}")
    result = traced_run(args)
    rep = result["spans"]
    tiers = rep["kmeans_ms_by_tier"]
    suffix = "single" if cell.traffic["entry"] == "encode" else "batch"
    kmeans_ms = result["metrics"].get(f"kmeans_ms.{suffix}", {}).get("value")
    RUN.log(f"portbench: kmeans by tier (ms/image): tier1 {tiers['tier1']:.3f}, tier23 "
            f"{tiers['tier23']:.3f}, other {tiers['other']:.3f}; kmeans_ms {kmeans_ms}")
    if "coverage" in rep:
        RUN.log(f"portbench: kmeans idle {rep['kmeans_idle_pct']}")
        RUN.log("portbench: idle by span " + json.dumps(rep["idle_by_span"]))
        RUN.log("portbench: coverage " + json.dumps(rep["coverage"]))
    RUN.log("portbench: slowest " + json.dumps(rep["slowest"]))
    RUN.log(f"portbench: span reduction {rep['reduction_s']:.3f} s over {rep['n_spans']} spans")
    for name, c in result["checks"].items():
        RUN.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
