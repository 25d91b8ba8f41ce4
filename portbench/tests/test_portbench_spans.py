"""The readers of the k-means and sync metrics on hand-built contexts, the
span reductions of `spans.py` on hand-built spans (the tier split adds up
to `kmeans_ms`), and one traced run of `spans.py` on the CPU."""

from __future__ import annotations

import time
import types

import pytest

from portbench import harness as H
from portbench import run as R
from portbench import spans as SP
from portbench import trace as TR
from roibasedimagecompression_torch.utils import timing

S = timing.Span
MS = 1_000_000  # ns


def _read(name, ctx):
    reader, suffix = H.metric_reader(name)
    return reader.read(ctx, suffix)


def test_seed_and_noise_readers():
    stages = {"kmeans.seed": {"seconds": 0.8}, "kmeans.noise": {"seconds": 0.3},
              "kmeans.lloyd": {"seconds": 2.0}, "epscc.kmeans": {"seconds": 3.0}}
    ctx = types.SimpleNamespace(images=10, stages=stages)
    assert _read("kmeans_seed_ms.batch", ctx) == pytest.approx(80.0)
    assert _read("noise_table_ms.single", ctx) == pytest.approx(30.0)
    # Every draw hit the cache: 0, not nothing.
    del stages["kmeans.noise"]
    assert _read("noise_table_ms.batch", ctx) == 0.0
    # A program without the k-means spans: nothing.
    ctx.stages = {"epscc.kmeans": {"seconds": 3.0}}
    assert _read("kmeans_seed_ms.batch", ctx) is None
    assert _read("noise_table_ms.batch", ctx) is None


def test_iterations_reader_counts_window_and_slice():
    timing.reset_stages()
    try:
        timing.count("kmeans_iters", 120)
        timing.count("other", 9)
        ctx = types.SimpleNamespace(images=16, trace=types.SimpleNamespace(images=8))
        assert _read("kmeans_iters_per_image.batch", ctx) == pytest.approx(5.0)
        ctx.trace = None
        assert _read("kmeans_iters_per_image.single", ctx) == pytest.approx(7.5)
        timing.reset_stages()
        assert _read("kmeans_iters_per_image.batch", ctx) is None
    finally:
        timing.reset_stages()


def test_host_syncs_reader():
    host = [(0.0, 0.1, "cudaStreamSynchronize"), (0.2, 0.3, "cudaMemcpyAsync"),
            (0.3, 0.4, "cudaStreamSynchronize"), (0.5, 0.6, "cudaDeviceSynchronize"),
            (0.6, 0.7, "cudaEventSynchronize"), (0.7, 0.8, "cudaMemcpy"),
            (0.8, 0.9, "aten::item"), (0.9, 1.0, "cudaLaunchKernel")]
    sl = TR.Slice(window_s=1.0, device=[(0.0, 0.5, "k")], host=host, images=5)
    assert _read("host_syncs_per_image.batch", types.SimpleNamespace(trace=sl)) == 1.0
    sl.device = []  # a trace without device activity reads nothing
    assert _read("host_syncs_per_image.single", types.SimpleNamespace(trace=sl)) is None


def _tiers_spans():
    """Two requests of encode_many: per request tier 1 holds two k-means
    (3 + 2 ms), tiers 2/3 one (4 ms); an `epscc.kmeans` outside both tiers
    (1 ms) goes to `other`."""
    spans = []
    for r, base in ((1, 0), (2, 100 * MS)):
        root = len(spans)
        spans += [S("encode_many", base, base + 90 * MS, None, r, 1),
                  S("s.tier1", base + 10 * MS, base + 30 * MS, root, r, 1),
                  S("t1.epscc", base + 11 * MS, base + 29 * MS, root + 1, r, 1),
                  S("epscc.kmeans", base + 12 * MS, base + 15 * MS, root + 2, r, 1),
                  S("kmeans.seed", base + 12 * MS, base + 13 * MS, root + 3, r, 1),
                  S("kmeans.lloyd", base + 13 * MS, base + 15 * MS, root + 3, r, 1),
                  S("epscc.kmeans", base + 20 * MS, base + 22 * MS, root + 2, r, 1),
                  S("s.tier23", base + 40 * MS, base + 60 * MS, root, r, 1),
                  S("t23.epscc", base + 41 * MS, base + 59 * MS, root + 7, r, 1),
                  S("epscc.kmeans", base + 50 * MS, base + 54 * MS, root + 8, r, 1)]
    spans.append(S("epscc.kmeans", 300 * MS, 301 * MS, None, None, 1))
    return spans


def test_tier_split_adds_up_to_kmeans_ms():
    spans = _tiers_spans()
    by_tier = SP.kmeans_by_tier(spans)
    assert by_tier == pytest.approx({"tier1": 0.010, "tier23": 0.008, "other": 0.001})
    kmeans_s = sum((s.end - s.start) / 1e9 for s in spans if s.name == "epscc.kmeans")
    images = 16
    ctx = types.SimpleNamespace(images=images, stages={"epscc.kmeans": {"seconds": kmeans_s}})
    rep = SP.report(spans, len(spans), [], images, None, None)
    tiers = rep["kmeans_ms_by_tier"]
    assert tiers["tier1"] + tiers["tier23"] + tiers["other"] == pytest.approx(
        _read("kmeans_ms.batch", ctx))
    assert "coverage" not in rep


def test_requests_are_matched_to_the_window_in_order():
    spans = _tiers_spans()
    records = [{"ids": [7, 3], "in_window": True}, {"ids": [4, 1], "in_window": True}]
    rep = SP.report(spans, len(spans), records, 4, None, None)
    slowest = rep["slowest"]
    assert [r["first_id"] for r in slowest] == [7, 4]
    assert slowest[0]["stages"] == pytest.approx({"s.tier1": 0.020, "s.tier23": 0.020})
    assert slowest[0]["seconds"] == pytest.approx(0.090)
    # The root's own self time is the time outside both stages.
    assert slowest[0]["self"]["encode_many"] == pytest.approx(0.050)


def test_device_reductions_against_spans():
    spans = [S("encode", 0, 100 * MS, None, 1, 1),
             S("tier1", 10 * MS, 50 * MS, 0, 1, 1),
             S("kmeans.seed", 10 * MS, 20 * MS, 1, 1, 1),
             S("kmeans.lloyd", 20 * MS, 40 * MS, 1, 1, 1),
             S("tier23", 60 * MS, 90 * MS, 0, 1, 1)]
    device = [(0.030, 0.039, "k"), (0.012, 0.014, "k"), (0.061, 0.0895, "copy"),
              (0.095, 0.096, "late"), (0.0131, 0.0135, "inside another")]
    dev = SP.Device(device)
    assert dev.busy == pytest.approx(0.0405) == TR.busy_seconds(device)
    assert dev.idle([(0.0, 0.1)]) == pytest.approx(0.1 - 0.0405)
    assert dev.idle([(0.013, 0.031)]) == pytest.approx(0.016)
    assert dev.idle([(0.0125, 0.0135)]) == 0.0
    # Overlapping intervals count once.
    assert dev.idle([(0.013, 0.031), (0.020, 0.035), (0.0131, 0.0132)]) == pytest.approx(0.022 - 0.006)
    # k-means spans 10-40 ms, busy 2 + 9 ms of it.
    assert SP.idle_share_within(spans, ("kmeans.seed", "kmeans.lloyd"), dev) == pytest.approx(
        100 * (1 - 11 / 30))
    idle = dict(SP.idle_by_span(spans, dev, (0.0, 0.1)))
    assert idle == pytest.approx({"encode": 0.010 + 0.010 + 0.005 + 0.004, "kmeans.seed": 0.008,
                                  "kmeans.lloyd": 0.011, "tier1": 0.010, "tier23": 0.0015})
    # Before the root opens, the idle time is outside every span.
    stages = [spans[1]._replace(parent=None), spans[4]._replace(parent=None)]
    assert dict(SP.idle_by_span(stages, dev, (0.0, 0.1))) == pytest.approx(
        {"outside spans": 0.029, "tier1": 0.029, "tier23": 0.0015})
    cov = SP.coverage(spans, dev)
    assert cov["busy_in_stages_pct"] == pytest.approx(100 * 39.5 / 40.5)
    # tier1's operations run 12-39 ms, tier23's 61-89.5 ms.
    assert cov["start_lead_ms"] == pytest.approx({"min": 1.0, "median": 2.0})
    assert cov["end_lag_ms"] == pytest.approx({"min": 0.5, "median": 11.0})


def test_a_traced_run_on_the_cpu(tiny_bench):
    args = R.parse_args(["--workload", "kodak768-lowlat.single", "--seed", str(2**31 + 77),
                         "--seconds", "0.01", "--trace", "0"])
    result = SP.traced_run(args, device="cpu", bench=tiny_bench, t_start=time.perf_counter())
    rep = result["spans"]
    # Recording is off again and run.py's hooks are the program's own.
    assert timing.record(False) is False and timing.reset_stages.__module__ == timing.__name__
    assert rep["n_spans"] > 0 and rep["slowest"]
    assert all("first_id" in r and "tier1" in r["stages"] for r in rep["slowest"])
    assert set(rep["kmeans_ms_by_tier"]) == {"tier1", "tier23", "other"}
    assert "encode_mpix_per_s" in result["metrics"]
    timing.reset_spans()


def test_a_traced_run_reaches_run_py_through_its_three_seams(tiny_bench, monkeypatch):
    """`traced_run` works through `run.py`'s calls of `timing.reset_stages`,
    `trace.profile_slice` and `harness.check_answers`, looked up through
    their modules: each leaves its mark in the readings.  A stand-in for
    the profiler gives the slice one device interval per image on the CPU."""

    def cpu_slice(fn):
        t0 = time.time_ns() / 1e9
        images = fn()
        t1 = time.time_ns() / 1e9
        device = [(t0 + (t1 - t0) * (k + 0.5) / images, t0 + (t1 - t0) * (k + 0.6) / images, "k")
                  for k in range(images)]
        return TR.Slice(window_s=t1 - t0, device=device, host=[], images=images)

    monkeypatch.setattr(TR, "profile_slice", cpu_slice)
    args = R.parse_args(["--workload", "kodak768-lowlat.single", "--seed", str(2**31 + 78),
                         "--seconds", "0.01", "--trace", "1"])
    rep = SP.traced_run(args, device="cpu", bench=tiny_bench, t_start=time.perf_counter())["spans"]
    assert TR.profile_slice is cpu_slice and timing.record(False) is False
    # reset_stages: the window's spans are recorded.
    assert rep["slowest"] and all("tier1" in r["stages"] for r in rep["slowest"])
    # check_answers: the window's requests carry their first image ids.
    assert all("first_id" in r for r in rep["slowest"])
    # profile_slice: the slice's spans are set against its device intervals
    # (those that fall between two requests' stages lie outside them).
    assert rep["coverage"]["stages"] > 0 and 0 < rep["coverage"]["busy_in_stages_pct"] <= 100
    assert rep["idle_by_span"] and rep["kmeans_idle_pct"] is not None
    timing.reset_spans()
