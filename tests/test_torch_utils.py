"""PyTorch port, the utilities of the entry surface: call routing
(dispatch), build keys (cachekey), warm-up (warmup), tracing (profiling)
and operation accounting (flops), with the cases of the JAX package's own
tests where they carry over ("warm" meaning: run inline)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import pipeline_jit as TPJ
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils import cachekey, dispatch, flops, profiling, timing, warmup
from roibasedimagecompression_torch.utils.synthetic import synthetic_image


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test's torch work on one thread and restores the count after:
    the suite runs several worker processes on the host's cores, and a torch
    thread pool per worker only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ dispatch
def test_calls_dispatch_inline():
    calls = []

    def fn(x):
        calls.append(x.shape)
        return x + 1

    a = np.zeros((4, 4), np.float32)
    for _ in range(2):
        got = dispatch.call(fn, a)
        assert isinstance(got, np.ndarray) and np.array_equal(got, a + 1)
    assert len(calls) == 2


def test_failed_call_is_kept_in_its_future():
    """A call's exception is raised at the call; the next call runs anew."""
    boom = []

    def fn(x):
        if not boom:
            boom.append(1)
            raise RuntimeError("first call fails")
        return x

    a = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="first call fails"):
        dispatch.call(fn, a)
    assert dispatch.call(fn, a) is a


def test_call_runs_once_a_shard_and_gathers():
    """A sharded argument: one call a shard on its device, the other tensor
    argument copied there, the tensors concatenated by rows and the counts
    gathered by their maximum."""
    from roibasedimagecompression_torch.parallel import mesh as TMESH
    from roibasedimagecompression_torch.parallel import shard as SHARD

    mesh = TMESH.make_mesh(2, devices=["cpu"] * 2)
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    shift = torch.tensor([10.0, 20.0])
    seen = []

    def fn(rows, add, *, scale):
        seen.append(tuple(rows.shape))
        return rows * scale + add, int(rows[0, 0])

    got, count = dispatch.call(fn, SHARD.shard_rows(x, mesh), shift, scale=2.0)
    assert seen == [(3, 2), (3, 2)]
    assert torch.equal(got, x * 2.0 + shift) and count == 6
    assert dispatch.call(fn, x, shift, scale=2.0)[1] == 0 and seen[-1] == (6, 2)


def _double(x):
    return x * 2


def test_call_records_a_manifest_entry_only_while_recording(monkeypatch):
    monkeypatch.setattr(warmup, "_entries", [])
    monkeypatch.setattr(warmup, "_seen", set())
    monkeypatch.setattr(warmup, "_recording", False)
    a = torch.zeros((4, 2))
    assert torch.equal(dispatch.call(_double, a), a)
    assert warmup._entries == []
    monkeypatch.setattr(warmup, "_recording", True)
    dispatch.call(_double, a)
    dispatch.call(_double, torch.ones((4, 2)))  # the same signature: one entry
    assert warmup._entries == [{"fn": f"{__name__}:_double", "args": [
        {"t": "arr", "shape": [4, 2], "dtype": "float32"}], "kwargs": {}}]


def test_call_counts_operations_only_while_enabled():
    was = flops.enabled()
    flops.enable()
    flops.reset()
    try:
        a, b = torch.ones(8, 16), torch.ones(16, 4)
        assert torch.equal(dispatch.call(torch.matmul, a, b), torch.full((8, 4), 16.0))
        assert flops.totals()[0] == 2 * 8 * 16 * 4
        flops.disable()
        dispatch.call(torch.matmul, a, b)
        assert flops.totals()[0] == 2 * 8 * 16 * 4
    finally:
        flops.reset()
        (flops.enable if was else flops.disable)()


def test_kernel_launch_record():
    """One Counter a kernel source, kept as the same object by its reset;
    `slic_assign.launch_shapes` is the record's own."""
    import collections

    from roibasedimagecompression_torch.ops.cuda import _build
    from roibasedimagecompression_torch.ops.cuda import slic_assign as TSA

    assert set(_build.launched) == set(_build.KERNELS)
    assert all(isinstance(c, collections.Counter) for c in _build.launched.values())
    counters = dict(_build.launched)
    assert TSA.launch_shapes is counters["slic_assign"]
    saved = {name: collections.Counter(c) for name, c in counters.items()}
    try:
        TSA.launch_shapes[("direct", 1, 64, 8)] += 2
        _build.launched["epscc"][("sweep", 1, 64)] += 1
        assert TSA.launch_shapes.total() >= 2
        _build.reset_launches()
        assert all(_build.launched[name] is counters[name] for name in _build.KERNELS)
        assert not any(_build.launched.values()) and not TSA.launch_shapes
    finally:
        for name, c in saved.items():
            _build.launched[name].update(c)


# ------------------------------------------------------------------ cachekey
_NVCC = (
    "nvcc: NVIDIA (R) Cuda compiler driver\n"
    "Copyright (c) 2005-2024 NVIDIA Corporation\n"
    "Built on Thu_Mar_28_02:18:24_PDT_2024\n"
    "Cuda compilation tools, release 12.4, V12.4.131\n"
    "Build cuda_12.4.r12.4/compiler.34097967_0"
)


def test_stable_compiler_string_drops_build_stamp_keeps_release():
    s = cachekey.stable_compiler_string(_NVCC)
    assert "Built on" not in s and "Thu_Mar_28" not in s
    assert "release 12.4" in s
    assert cachekey.release_line(_NVCC) == "release 12.4"
    with pytest.raises(ValueError):
        cachekey.release_line("no version here")


def test_build_key_differs_on_release_bump():
    src, flags = b"__global__ void k() {}", ["-O3", "-gencode", "arch=compute_90a,code=sm_90a"]
    bumped = _NVCC.replace("release 12.4, V12.4.131", "release 12.6, V12.6.20")
    assert cachekey.build_key(src, flags, cachekey.release_line(_NVCC)) != cachekey.build_key(
        src, flags, cachekey.release_line(bumped))
    assert cachekey.build_key(src, flags, "release 12.4") != cachekey.build_key(src + b" ", flags, "release 12.4")
    assert cachekey.build_key(src, flags, "release 12.4") != cachekey.build_key(src, flags[:1], "release 12.4")


def test_build_key_same_across_builds_and_paths():
    redeployed = _NVCC.replace("Thu_Mar_28_02:18:24_PDT_2024", "Tue_Jun_11_00:01:02_PDT_2024")
    key = cachekey.build_key(b"x", ["-O3"], cachekey.release_line(_NVCC))
    assert key == cachekey.build_key(b"x", ["-O3"], cachekey.release_line(redeployed))
    assert len(key) == 12 and int(key, 16) >= 0


def test_identity_report_shape():
    from roibasedimagecompression_torch.ops.cuda import _build

    r = cachekey.identity_report()
    assert {"torch", "cuda", "nvcc_release", "device_name", "capability", "build_keys",
            "native_lib"} <= set(r)
    assert set(r["build_keys"]) == set(_build.KERNELS)
    assert r["torch"] == torch.__version__


# -------------------------------------------------------------------- warmup
def test_warmup_manifest_roundtrip(tmp_path, monkeypatch):
    """A recorded small CPU encode gives a replayable manifest: every entry
    resolves, and prewarm replays all of them with zero inputs."""
    monkeypatch.setattr(warmup, "_entries", [])
    monkeypatch.setattr(warmup, "_seen", set())
    monkeypatch.setattr(warmup, "_recording", True)
    img = synthetic_image(30, 96, 96)
    TSTREAM.encode_many([img, img[::-1].copy()], tcfg.CodecConfig(), device="cpu")
    path = str(tmp_path / "manifest.json")
    n = warmup.save(path)
    assert n >= 2  # split score and SLIC buckets at least
    entries = json.load(open(path))
    names = {e["fn"] for e in entries}
    assert any("_split_score_batch" in x for x in names) and any("_slic_core_batch" in x for x in names)
    for e in entries:
        assert callable(warmup._resolve(e["fn"]))
    assert warmup.prewarm(path, block=True, device="cpu") == n
    assert warmup.prewarm(block=True, device="cpu") == 0


def test_source_fingerprint_and_freshness():
    fp = warmup.source_fingerprint()
    assert len(fp) == 16 and fp == warmup.source_fingerprint()
    lines = []
    fresh = warmup.check_pack_freshness(log=lines.append)
    assert isinstance(fresh, bool)
    if not fresh:
        assert lines


# ----------------------------------------------------------------- profiling
def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("work"):
            with timing.stage_timer("stage.work"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
                with timing.stage_timer("stage.inner"):
                    pass
    assert os.path.exists(prof.trace_path)
    trace = json.load(open(prof.trace_path))
    assert any(ev.get("name") == "work" for ev in trace["traceEvents"])
    # The program's span, on the trace's clock: it contains the matmul.
    (span,) = [ev for ev in trace["traceEvents"] if ev.get("name") == "stage.work"]
    assert span["cat"] == "stage" and span["tid"] == threading.get_native_id()
    (mm,) = [ev for ev in trace["traceEvents"] if ev.get("name") == "aten::matmul"]
    assert span["ts"] - 1e3 <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"] + 1e3
    # Parents are indices among the written spans.
    (inner,) = [ev for ev in trace["traceEvents"] if ev.get("name") == "stage.inner"]
    assert span["args"]["parent"] is None and inner["args"]["parent"] == span["args"]["id"]
    assert timing.record(False) is False  # recording is off again after the block
    assert timing.spans() == []  # and the block's spans are not kept


# --------------------------------------------------------------------- flops
def test_flops_count_analysis_step():
    was = flops.enabled()
    flops.enable()
    flops.reset()
    try:
        img = synthetic_image(9, 64, 64)
        flops.track(TPJ.analysis_step, (img,), {"n_centers_side": 4, "palette_cap": 512, "device": "cpu"})
        f, b = flops.totals()
        assert f > 0 and b > 0
        before = flops.totals()[0]
        flops.track(torch.matmul, (torch.ones(8, 16), torch.ones(16, 4)), {})
        assert flops.totals()[0] - before == 2 * 8 * 16 * 4
        flops.disable()
        flops.track(torch.matmul, (torch.ones(8, 16), torch.ones(16, 4)), {})
        assert flops.totals()[0] - before == 2 * 8 * 16 * 4
    finally:
        flops.reset()
        (flops.enable if was else flops.disable)()
    assert flops.H100_PEAK_F32 == 67e12
