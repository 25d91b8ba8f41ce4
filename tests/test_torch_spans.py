"""PyTorch port, tracing: the stage spans of `utils/timing.py` (parents,
request ids across threads, self time, the profiler's clock, recording off)
and the k-means's spans and counters (`ops/cluster.py`)."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.synthetic import synthetic_image



@pytest.fixture(autouse=True)
def clean_registry():
    """Each test starts with recording off and empty registries, and leaves
    them so: the worker process runs other files' tests after these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.record(False)
    timing.reset_spans()
    timing.reset_stages()
    yield
    timing.record(False)
    timing.reset_spans()
    timing.reset_stages()
    torch.set_num_threads(n)


@pytest.fixture
def recording():
    timing.record(True)
    yield
    timing.record(False)


def _ancestors(spans, i):
    out = []
    while spans[i].parent is not None:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def _images(n, seed=5):
    return [synthetic_image(seed + k, 64, 80) for k in range(n)]


def test_nested_stage_timers_record_parents(recording):
    with timing.stage_timer("a"):
        with timing.stage_timer("b"):
            with timing.stage_timer("c"):
                pass
        with timing.stage_timer("d"):
            pass
    with timing.stage_timer("e"):
        pass
    spans = timing.spans()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    assert all(s.request is None and s.thread == threading.get_native_id() for s in spans)
    for s in spans:
        assert s.end is not None and s.end >= s.start
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    report = timing.stage_report()
    assert set(report) == {"a", "b", "c", "d", "e"}
    for name, s in zip("abcde", spans):
        assert report[name] == {"seconds": pytest.approx((s.end - s.start) / 1e9), "calls": 1}


def test_encode_many_calls_get_one_request_each_with_io_pool_spans(recording):
    imgs = _images(2)
    config = tcfg.CodecConfig.low_latency()
    first = TSTREAM.encode_many(imgs, config, device="cpu")
    TSTREAM.encode_many(imgs, config, device="cpu")
    spans = timing.spans()
    roots = [i for i, s in enumerate(spans) if s.name == "encode_many"]
    assert len(roots) == 2
    ids = [spans[i].request for i in roots]
    assert ids[0] != ids[1] and None not in ids
    assert all(spans[i].parent is None for i in roots)
    main = threading.get_native_id()
    for i, s in enumerate(spans):
        assert s.request in ids
        if i not in roots:
            assert _ancestors(spans, i)[-1] == "encode_many"
            assert spans[roots[ids.index(s.request)]].start <= s.start
    packs = [s for s in spans if s.name == "container.pack"]
    assert len(packs) == 4
    for s in packs:
        assert s.thread != main
        assert spans[s.parent].name == "s.container"
        assert spans[s.parent].request == s.request
    assert sorted(s.request for s in packs) == sorted(ids * 2)
    # Recording changes no byte.
    timing.record(False)
    assert TSTREAM.encode_many(imgs, config, device="cpu") == first


def test_encode_calls_get_one_request_each(recording):
    img = _images(1, seed=9)[0]
    TCODEC.encode(img, tcfg.CodecConfig.low_latency(), device="cpu")
    TCODEC.encode(img, tcfg.CodecConfig.low_latency(), device="cpu")
    spans = timing.spans()
    roots = [i for i, s in enumerate(spans) if s.name == "encode"]
    assert len(roots) == 2 and spans[roots[0]].request != spans[roots[1]].request
    for i, s in enumerate(spans):
        if i not in roots:
            assert s.request == spans[roots[0] if i < roots[1] else roots[1]].request
            assert _ancestors(spans, i)[-1] == "encode"
    top = {s.name for s in spans if s.parent in roots}
    assert top == {"roi", "segment", "tier1", "tier23", "container"}


def test_encode_stream_workers_share_the_stream_request(recording):
    batches = [_images(2, seed=5), _images(2, seed=7)]
    TSTREAM.encode_stream(batches, tcfg.CodecConfig.low_latency(), workers=2, device="cpu")
    spans = timing.spans()
    assert spans[0].name == "encode_stream" and spans[0].parent is None
    assert [s.name for s in spans].count("encode_many") == 0  # nested: no request of its own
    assert {s.request for s in spans} == {spans[0].request}
    main = threading.get_native_id()
    tops = [s for s in spans if s.name == "s.tier1"]
    assert len(tops) == 2 and all(s.parent == 0 for s in tops)
    assert len({s.thread for s in tops}) == 2 and main not in {s.thread for s in tops}
    for i in range(1, len(spans)):
        assert _ancestors(spans, i)[-1] == "encode_stream"


def test_self_time_is_duration_less_what_children_cover():
    S = timing.Span
    spans = [
        S("root", 0, 100, None, 1, 1),
        S("a", 10, 30, 0, 1, 1),
        S("b", 20, 50, 0, 1, 2),  # overlaps a (another thread): the union counts once
        S("c", 60, 70, 0, 1, 1),
        S("a.x", 12, 15, 1, 1, 1),
        S("open", 80, None, 0, 1, 1),  # still open: covers nothing
        S("late", 95, 120, 0, 1, 1),  # clipped to its parent's end
    ]
    assert timing.self_times(spans) == [100 - 40 - 10 - 5, 20 - 3, 30, 10, 3, None, 25]


def test_self_time_of_recorded_spans(recording):
    with timing.stage_timer("outer"):
        time.sleep(0.002)
        with timing.stage_timer("inner"):
            time.sleep(0.004)
    outer, inner = timing.spans()
    selfs = timing.self_times([outer, inner])
    assert selfs[1] == inner.end - inner.start
    assert selfs[0] == (outer.end - outer.start) - (inner.end - inner.start)
    assert selfs[0] >= 2_000_000


def test_recording_off_keeps_no_span_and_report_is_unchanged():
    assert timing.record(False) is False
    img = _images(1, seed=9)[0]
    config = tcfg.CodecConfig.low_latency()
    TCL._gumbel_table.cache_clear()  # both encodes draw the same noise tables
    data = TCODEC.encode(img, config, device="cpu")
    assert timing.spans() == []
    report = timing.stage_report()
    assert set(report) >= {"roi", "segment", "tier1", "tier23", "container"}
    assert all(set(v) == {"seconds", "calls"} for v in report.values())
    assert report["tier1"]["calls"] == 1
    # With recording on, the same names, calls and bytes, and no stage for
    # the request's root.
    timing.reset_stages()
    timing.record(True)
    TCL._gumbel_table.cache_clear()
    assert TCODEC.encode(img, config, device="cpu") == data
    timing.record(False)
    on = timing.stage_report()
    assert {k: v["calls"] for k, v in on.items()} == {k: v["calls"] for k, v in report.items()}
    # Off: nothing is kept, no thread state is set, carry and request add
    # nothing, and many stages hold no memory.
    timing.reset_spans()

    def fn():
        return 7

    assert timing.carry(fn) is fn
    with timing.request("encode"):
        pass
    with timing.stage_timer("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(5000):
            with timing.stage_timer("warm"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename.endswith("timing.py"))
    assert grown < 1024  # 5000 stages: no byte kept per stage
    assert timing.spans() == []
    assert getattr(timing._LOCAL, "cur", None) is None
    assert timing.stage_report()["warm"]["calls"] == 5001


def test_span_clock_is_the_profilers():
    """A span around sleep, add, sleep contains the kineto interval of the
    add, within 1 ms on either side, and the add starts after the first
    sleep."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(16)
    timing.record(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.stage_timer("clock"):
            time.sleep(0.002)
            x + 1
            time.sleep(0.002)
    timing.record(False)
    (span,) = timing.spans()
    adds = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::add"]
    assert len(adds) == 1
    lo, hi = adds[0].start_ns(), adds[0].start_ns() + adds[0].duration_ns()
    assert span.start - 1_000_000 <= lo and hi <= span.end + 1_000_000
    assert lo - span.start >= 1_000_000


def test_device_trace_inside_a_recording_keeps_its_spans(tmp_path):
    """Recording on before the block: the spans stay recorded after it.  The
    trace holds the spans that opened in the block and are still recorded,
    a parent that opened before the block is written as None, and a reset
    inside the block drops the spans before it from the trace too."""
    import json

    from roibasedimagecompression_torch.utils import profiling

    def written(prof):
        trace = json.load(open(prof.trace_path))
        return {ev["name"]: ev["args"] for ev in trace["traceEvents"] if ev.get("cat") == "stage"}

    timing.record(True)
    with timing.stage_timer("outer"):
        with profiling.device_trace(str(tmp_path)) as prof:
            with timing.stage_timer("kept"):
                with timing.stage_timer("kept.inner"):
                    pass
    assert [s.name for s in timing.spans()] == ["outer", "kept", "kept.inner"]
    args = written(prof)
    assert set(args) == {"kept", "kept.inner"}
    assert args["kept"]["parent"] is None and args["kept.inner"]["parent"] == args["kept"]["id"]

    with profiling.device_trace(str(tmp_path)) as prof:
        with timing.stage_timer("dropped"):
            pass
        timing.reset_spans()
        with timing.stage_timer("after"):
            pass
    assert timing.record(False) is True
    assert [s.name for s in timing.spans()] == ["after"]
    assert set(written(prof)) == {"after"}


def test_reset_while_a_span_is_open():
    timing.record(True)
    with timing.stage_timer("old"):
        timing.reset_spans()
        with timing.stage_timer("new"):
            pass
    (new,) = timing.spans()
    assert new.name == "new" and new.parent is None and new.end is not None


def test_kmeans_counts_its_lloyd_iterations():
    """Points 0, 1, 100, 101 from centres 0 and 1: the first assignment puts
    1, 100, 101 together, the second moves 1 over, the third changes
    nothing and stops the loop: 3 iterations."""
    pts = torch.zeros((1, 4, 3), dtype=torch.float32)
    pts[0, :, 0] = torch.tensor([0.0, 1.0, 100.0, 101.0])
    valid = torch.ones((1, 4), dtype=torch.bool)
    init = torch.zeros((1, 2, 3), dtype=torch.float32)
    init[0, 1, 0] = 1.0
    labels = TCL.kmeans_rows(pts, valid, [2], k_max=2, init_centers=init)
    assert labels.tolist() == [[0, 0, 1, 1]]
    # 4 points x 2 centres, in 3 passes and the last assignment, each on
    # the host (the CPU's route)
    assert timing.counters() == {"kmeans_iters": 3, "kmeans_assign_pairs": 4 * 2 * 4,
                                 "kmeans_assign.host": 4}
    TCL.kmeans_rows(pts, valid, [2], k_max=2, init_centers=init, iters=2)
    assert timing.counters() == {"kmeans_iters": 5, "kmeans_assign_pairs": 32 + 4 * 2 * 3,
                                 "kmeans_assign.host": 7}
    timing.reset_stages()
    assert timing.counters() == {}


def test_kmeans_counts_where_its_noise_was_drawn():
    """A k-means++ seeding on the CPU draws its noise on the host, inside one
    `kmeans.noise` span on a cache miss, and launches no kernel; given
    initial centres or seeded random ones, no Gumbel noise is drawn and no
    seeding is counted."""
    from roibasedimagecompression_torch.ops.cuda import _build

    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.integers(0, 256, (2, 64, 3)).astype(np.float32))
    valid = torch.ones((2, 64), dtype=torch.bool)
    card = _build.launched["gumbel"].total()
    TCL._gumbel_table.cache_clear()

    def noise():
        c, s = timing.counters(), timing.stage_report()
        return (c.get("kmeans_seed.loop", 0), c.get("kmeans_seed.kernel", 0),
                s.get("kmeans.noise", {}).get("calls", 0), _build.launched["gumbel"].total() - card)

    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11)
    assert noise() == (1, 0, 1, 0)
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11, plusplus=False)
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, init_centers=pts[:, :8])
    assert noise() == (1, 0, 1, 0)
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=12, weights=torch.ones((2, 64)))
    assert noise() == (2, 0, 2, 0)
    TCL._gumbel_table.cache_clear()


def test_kmeans_counts_its_uniform_starts():
    """One `kmeans_init.uniform` per seeded random start; none for a
    k-means++ start or given centres."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.integers(0, 256, (2, 64, 3)).astype(np.float32))
    valid = torch.ones((2, 64), dtype=torch.bool)

    def uniform():
        return timing.counters().get("kmeans_init.uniform", 0)

    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11)
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, init_centers=pts[:, :8])
    assert uniform() == 0
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11, plusplus=False)
    assert uniform() == 1
    TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=12, plusplus=False)
    assert uniform() == 2
    assert timing.counters()["kmeans_seed.loop"] == 1


def test_kmeans_assign_pairs_count_valid_points_times_k():
    """Two rows padded to 64 points, 50 and 20 of them valid, k 5 and 3 of
    k_max 8: each assignment pass counts 50 x 5 + 20 x 3 pairs, the padding
    none; the passes are the Lloyd iterations and the last assignment."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.integers(0, 256, (2, 64, 3)).astype(np.float32))
    valid = torch.arange(64)[None, :] < torch.tensor([[50], [20]])
    pts[~valid] = 0.0
    for plusplus in (True, False):
        timing.reset_stages()
        TCL.kmeans_rows(pts, valid, [5, 3], k_max=8, seed=7, plusplus=plusplus)
        c = timing.counters()
        assert c["kmeans_iters"] >= 2
        assert c["kmeans_assign_pairs"] == (50 * 5 + 20 * 3) * (c["kmeans_iters"] + 1)
    timing.reset_stages()
    TCL.kmeans_rows(pts, valid, [5, 3], k_max=8, seed=7, iters=1)
    assert timing.counters()["kmeans_assign_pairs"] == (50 * 5 + 20 * 3) * 2


def test_kmeans_spans_sit_under_their_caller(recording):
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.integers(0, 256, (2, 64, 3)).astype(np.float32))
    valid = torch.ones((2, 64), dtype=torch.bool)
    with timing.stage_timer("epscc.kmeans"):
        TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11)
        TCL.kmeans_rows(pts, valid, [4, 5], k_max=8, seed=11, plusplus=False)
    spans = timing.spans()
    names = [s.name for s in spans if s.name != "kmeans.noise"]
    assert names == ["epscc.kmeans", "kmeans.seed", "kmeans.lloyd", "kmeans.seed", "kmeans.lloyd"]
    for i, s in enumerate(spans):
        if s.name in ("kmeans.seed", "kmeans.lloyd"):
            assert s.parent == 0
        if s.name == "kmeans.noise":
            assert spans[s.parent].name == "kmeans.seed"


def test_noise_span_on_a_cache_miss_only(recording):
    TCL._gumbel_table.cache_clear()
    try:
        a = TCL._gumbel_table(123, 32, 4)
        assert [s.name for s in timing.spans()] == ["kmeans.noise"]
        b = TCL._gumbel_table(123, 32, 4)
        assert b is a
        assert [s.name for s in timing.spans()] == ["kmeans.noise"]
        TCL._gumbel_table(123, 64, 4)
        assert [s.name for s in timing.spans()] == ["kmeans.noise", "kmeans.noise"]
        assert timing.stage_report()["kmeans.noise"]["calls"] == 2
    finally:
        TCL._gumbel_table.cache_clear()
