"""The readers of the Lloyd metrics (`kmeans_lloyd_ms`,
`kmeans_assign_gpairs_per_image`, `kmeans_lloyd_roofline`) on hand-built
contexts and counters, and on a program without the counters."""

from __future__ import annotations

import types

import pytest

from portbench import harness as H
from portbench import roofline as RL
from roibasedimagecompression_torch.utils import timing


def _read(name, ctx):
    reader, suffix = H.metric_reader(name)
    return reader.read(ctx, suffix)


@pytest.fixture(autouse=True)
def clean_registry():
    timing.reset_stages()
    yield
    timing.reset_stages()


def test_lloyd_ms_reads_the_lloyd_stage_per_window_image():
    ctx = types.SimpleNamespace(images=8, stages={"kmeans.lloyd": {"seconds": 2.0},
                                                  "kmeans.seed": {"seconds": 1.0}})
    assert _read("kmeans_lloyd_ms.batch", ctx) == pytest.approx(250.0)
    ctx.stages = {"epscc.kmeans": {"seconds": 3.0}}
    assert _read("kmeans_lloyd_ms.batch", ctx) is None


def test_pairs_reader_counts_window_and_slice():
    timing.count("kmeans_assign_pairs", 3 * 10**9)
    timing.count("kmeans_iters", 7)
    ctx = types.SimpleNamespace(images=16, trace=types.SimpleNamespace(images=8))
    assert _read("kmeans_assign_gpairs_per_image.batch", ctx) == pytest.approx(0.125)
    ctx.trace = None
    assert _read("kmeans_assign_gpairs_per_image.batch", ctx) == pytest.approx(3 / 16)


def test_roofline_count_of_a_known_case():
    from portbench.metrics import kmeans_lloyd_roofline as LR

    # Two passes over a row of 100,000 valid points and k 900: 180 M pairs.
    pairs = 2 * 100_000 * 900
    ops, nbytes = LR.lloyd_ops_bytes(pairs)
    assert ops == 9 * pairs and nbytes == 0
    assert RL.bound_s(ops, nbytes) == pytest.approx(9 * pairs / 67e12)


def test_roofline_reads_100_at_its_bound():
    from portbench.metrics import kmeans_lloyd_roofline as LR

    pairs = 95_000_000 * 27
    bound = RL.bound_s(*LR.lloyd_ops_bytes(pairs))
    assert LR.share_pct(pairs, bound) == pytest.approx(100.0)
    assert LR.share_pct(pairs, 4 * bound) == pytest.approx(25.0)
    assert LR.share_pct(pairs, 0.0) is None


def test_roofline_reads_the_live_counter_and_lloyd_stage(monkeypatch):
    from portbench.metrics import kmeans_lloyd_roofline as LR

    pairs = 10**9
    bound = RL.bound_s(*LR.lloyd_ops_bytes(pairs))
    timing.count("kmeans_assign_pairs", pairs)
    monkeypatch.setattr(timing, "stage_report",
                        lambda: {"kmeans.lloyd": {"seconds": 2 * bound, "calls": 3}})
    ctx = types.SimpleNamespace(images=8, trace=types.SimpleNamespace(images=8))
    assert _read("kmeans_lloyd_roofline.batch", ctx) == pytest.approx(50.0)


def test_readers_report_nothing_on_a_program_without_the_counters(monkeypatch):
    """The parent program has the `kmeans.lloyd` span but neither counter:
    the pair and roofline readers give None, and nothing raises."""
    timing.count("kmeans_iters", 40)
    ctx = types.SimpleNamespace(images=8, trace=types.SimpleNamespace(images=8),
                                stages={"kmeans.lloyd": {"seconds": 1.0}})
    monkeypatch.setattr(timing, "stage_report", lambda: dict(ctx.stages))
    assert _read("kmeans_assign_gpairs_per_image.batch", ctx) is None
    assert _read("kmeans_lloyd_roofline.batch", ctx) is None
    assert _read("kmeans_lloyd_ms.batch", ctx) == pytest.approx(125.0)
    # A program without a counter registry at all.
    monkeypatch.delattr(timing, "counters")
    assert _read("kmeans_assign_gpairs_per_image.batch", ctx) is None
    assert _read("kmeans_lloyd_roofline.batch", ctx) is None
