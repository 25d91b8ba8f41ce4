"""PyTorch port, the batch frontend's process-wide pool (`parallel/stream.py
_frontend_pool`): Canny threshold selection image by image on the pool
equals the serial selection, the route counters, one pool object across
calls, the per-image spans, and `encode_many`'s bytes against `encode`'s."""

import os

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.ops import canny as TCANNY
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.synthetic import synthetic_image


@pytest.fixture(autouse=True)
def clean_registry():
    timing.record(False)
    timing.reset_spans()
    timing.reset_stages()
    yield
    timing.record(False)
    timing.reset_spans()
    timing.reset_stages()


@pytest.fixture
def fresh_pool(monkeypatch):
    """The module's pool slot emptied for the test; the pool the test builds
    is shut down after it."""
    monkeypatch.setattr(TSTREAM, "_FRONTEND_POOL", None)
    yield
    if TSTREAM._FRONTEND_POOL is not None:
        TSTREAM._FRONTEND_POOL.shutdown()


def _batch(n, h, w, seed=40):
    return np.stack([synthetic_image(seed + k, h, w) for k in range(n)])


def _route_counts():
    c = timing.counters()
    return c.get("thresholds.pool", 0), c.get("thresholds.serial", 0)


@pytest.mark.parametrize("shape", [(512, 768), (101, 187)], ids=["768x512", "187x101"])
def test_pooled_thresholds_equal_serial_pairs(shape, fresh_pool):
    assert native.available()
    batch = _batch(4, *shape)
    pool = TSTREAM._frontend_pool()
    assert pool is not None
    lows, highs = TCANNY.select_thresholds_many(batch, None, pool)
    singles = [TCANNY.select_thresholds_pair(im) for im in batch]
    assert lows.dtype == highs.dtype == np.float32
    assert [(float(lo), float(hi)) for lo, hi in zip(lows, highs)] == singles
    s_lows, s_highs = TCANNY.select_thresholds_many(batch)
    assert np.array_equal(lows, s_lows) and np.array_equal(highs, s_highs)
    assert _route_counts() == (4, 4)


def test_route_counters_follow_the_usable_cores(monkeypatch, fresh_pool):
    imgs = list(_batch(3, 48, 64))
    config = tcfg.CodecConfig()
    TSTREAM.encode_many(imgs, config, device="cpu")
    assert _route_counts() == (3, 0)
    timing.reset_stages()
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert TSTREAM._frontend_pool() is None
    TSTREAM.encode_many(imgs, config, device="cpu")
    assert _route_counts() == (0, 3)


def test_fast_edges_and_single_region_skip_the_selection(fresh_pool):
    imgs = list(_batch(2, 48, 64))
    TSTREAM.encode_many(imgs, tcfg.CodecConfig.low_latency(), device="cpu")
    TSTREAM.encode_many(imgs, tcfg.CodecConfig(single_region=True), device="cpu")
    assert _route_counts() == (0, 0)
    assert "thresholds.image" not in timing.stage_report()


def test_encode_many_calls_share_one_pool(monkeypatch, fresh_pool):
    seen = []
    select = TCANNY.select_thresholds_many

    def spy(images, device=None, pool=None):
        seen.append(pool)
        return select(images, device, pool)

    monkeypatch.setattr(TCANNY, "select_thresholds_many", spy)
    imgs = list(_batch(2, 48, 64))
    TSTREAM.encode_many(imgs, device="cpu")
    TSTREAM.encode_many(imgs, device="cpu")
    assert len(seen) == 2 and seen[0] is not None
    assert seen[0] is seen[1] is TSTREAM._FRONTEND_POOL is TSTREAM._frontend_pool()
    assert seen[0]._max_workers == min(8, len(os.sched_getaffinity(0)))


def test_without_the_runtime_there_is_no_pool(monkeypatch, fresh_pool):
    monkeypatch.setattr(native, "available", lambda: False)
    assert TSTREAM._frontend_pool() is None
    assert TSTREAM._FRONTEND_POOL is None


def test_threshold_spans_run_on_the_pool_inside_the_stage(fresh_pool):
    imgs = list(_batch(3, 48, 64))
    timing.record(True)
    TSTREAM.encode_many(imgs, device="cpu")
    timing.record(False)
    spans = timing.spans()
    (root,) = [s for s in spans if s.name == "encode_many"]
    per_image = [s for s in spans if s.name == "thresholds.image"]
    assert len(per_image) == 3
    for s in per_image:
        assert spans[s.parent].name == "s.thresholds"
        assert s.request == root.request
    assert timing.stage_report()["thresholds.image"]["calls"] == 3


def test_encode_many_bytes_equal_encode(fresh_pool):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        imgs = list(_batch(3, 96, 128, seed=70))
        config = tcfg.CodecConfig()
        many = TSTREAM.encode_many(imgs, config, device="cpu")
        assert many == [TCODEC.encode(im, config, device="cpu") for im in imgs]
    finally:
        torch.set_num_threads(n)
