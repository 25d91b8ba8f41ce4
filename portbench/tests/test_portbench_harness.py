"""Discovery by name, the end-to-end arithmetic, the trace reduction and
the rules on loaded modules."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness as H
from portbench import images as IM
from portbench import roofline as RL
from portbench import trace as TR
from portbench.tests.conftest import BENCH_DIR, ROOT


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = H.resolve(bench, w["name"])
        assert cell.traffic["entry"] in ("encode_many", "encode")
        assert H.load_module("entries", cell.traffic["entry"]) is not None
        assert H.load_module("drivers", cell.traffic["driver"]) is not None
        assert cell.digests is not None
        ids = [str(i) for i in cell.config["images"]["ids"]]
        assert sorted(cell.digests["entries"][cell.traffic["entry"]]) == sorted(ids)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            if m["name"] != "setup_s":
                reader, _ = H.metric_reader(m["name"])
                assert callable(reader.read)


def test_a_new_file_and_entry_add_a_cell(tmp_path, bench):
    """A mix, a metric and a cell added as new files plus entries, with no
    file of the benchmark edited."""
    base = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(base, p), "rb").read()
              for p in ("traffic/batch8.json", "harness.py", "run.py")}
    (base / "traffic" / "batch4.json").write_text(json.dumps(
        {"driver": "closed_loop", "entry": "encode_many", "batch": 4,
         "warmup_requests": 1, "trace_requests": 1}))
    (base / "metrics" / "frontend_ms.batch4.py").write_text(
        "def read(ctx, suffix):\n    return 1.25\n")
    bench["workloads"].append({"name": "kodak768-lowlat.batch4", "config": "kodak768-lowlat",
                               "traffic": "batch4", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "frontend_ms.batch4", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Frontend",
                               "moves": "encode_mpix_per_s",
                               "workloads": ["kodak768-lowlat.batch4"]})
    for c in bench["configs"]:
        c["file"] = os.path.join(str(tmp_path), c["file"])
    cell = H.resolve(bench, "kodak768-lowlat.batch4", base=str(base))
    assert cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.per_layer] == ["frontend_ms.batch4"]
    reader, suffix = H.metric_reader("frontend_ms.batch4", base=str(base))
    assert suffix is None and reader.read(None, None) == 1.25
    # The stem's reader still serves the names that have no file of their own.
    reader, suffix = H.metric_reader("frontend_ms.batch", base=str(base))
    assert suffix == "batch"
    assert before == {p: open(os.path.join(base, p), "rb").read() for p in before}


def _ctx(requests, pixels_per_image=512 * 768):
    n = sum(len(r["ids"]) for r in requests)
    return types.SimpleNamespace(
        window_start=0.0, window_end=requests[-1]["end"], requests=requests, images=n,
        pixels=n * pixels_per_image, stages={}, trace=None)


def test_rate_counts_the_request_in_flight_whole():
    """Three batches of 8 started inside a 10 s window, the last ending at
    13 s: 24 images over 13 s."""
    reqs = [{"ids": list(range(8)), "start": s, "end": e} for s, e in ((0, 4), (4, 8), (8, 13))]
    reader, _ = H.metric_reader("encode_mpix_per_s")
    assert reader.read(_ctx(reqs), None) == pytest.approx(24 * 512 * 768 / 1e6 / 13.0)


def test_stage_and_entry_readers():
    stages = {"s.segment": {"seconds": 2.0}, "s.tier1": {"seconds": 5.0},
              "t1.pairs_dev": {"seconds": 0.5}, "epscc.kmeans": {"seconds": 4.0}}
    ctx = types.SimpleNamespace(window_start=0.0, window_end=10.0, images=10, stages=stages)
    read = lambda name: H.metric_reader(name)[0].read(ctx, name.split(".")[1])  # noqa: E731
    assert read("tier1_ms.batch") == pytest.approx(550.0)
    assert read("kmeans_ms.batch") == pytest.approx(400.0)
    assert read("frontend_ms.batch") == 0.0
    assert read("tier1_ms.single") == 0.0
    assert read("entry_other_ms.batch") == pytest.approx(250.0)


def test_trace_reduction():
    device = [(0.0, 1.0, "k_a"), (0.5, 2.0, "k_b"), (3.0, 3.5, "k_a"), (6.0, 6.25, "memcpy")]
    host = [(2.1, 2.9, "aten::nonzero"), (3.6, 5.9, "aten::item"), (2.0, 2.2, "cudaLaunchKernel")]
    assert TR.busy_seconds(device) == pytest.approx(2.75)
    assert TR.top_device_ops(device) == [["k_a", pytest.approx(1.5)], ["k_b", pytest.approx(1.5)],
                                         ["memcpy", pytest.approx(0.25)]]
    assert TR.idle_gaps(device, host) == [["aten::item", pytest.approx(2.5)],
                                          ["aten::nonzero", pytest.approx(1.0)]]
    assert TR.idle_gaps(device, []) [0][0] == "host code"


def test_roofline_share_of_a_launch_at_its_bound_is_100():
    ops, nbytes = RL.slic_assign_ops_bytes("expanded", 8, 221184, 64)
    assert ops == 15 * 8 * 221184 * 64
    assert nbytes == 4 * (8 * 221184 * 5 + 8 * 64 * 5 + 8 * 221184) + 8 * 64
    bound = RL.bound_s(ops, nbytes)
    assert bound == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    reader, _ = H.metric_reader("slic_assign_roofline.batch")
    sl = TR.Slice(window_s=1.0, device=[(0.0, bound, "void slic_assign_kernel<true>(...)")],
                  host=[], images=8,
                  counters={"slic_assign_shapes": {("expanded", 8, 221184, 64): 1}})
    assert reader.read(types.SimpleNamespace(trace=sl), "batch") == pytest.approx(100.0)
    sl.device = [(0.0, 1.0, "other_kernel")]
    assert reader.read(types.SimpleNamespace(trace=sl), "batch") is None


def test_arrival_order_keeps_the_set_and_its_groups():
    ids = list(range(100, 124))
    for seed in (0, 1, 2**31 + 5, 3_000_000_007):
        order = IM.arrival_order(ids, seed)
        assert [sorted(order[i:i + 8]) for i in range(0, 24, 8)] == [ids[0:8], ids[8:16], ids[16:24]]
        assert IM.arrival_order(ids, seed) == order
    assert IM.arrival_order(ids, 1) != IM.arrival_order(ids, 2)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "roibasedimagecompression_tpu_like", types.ModuleType("x"))
    assert "roibasedimagecompression_tpu_like" not in H.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in H.forbidden_loaded()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, in a fresh process: the harness, the
    reference, the trace reduction and both entry points with the program."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, harness as H, reference, trace, roofline, images\n"
        "for e in ('encode_many', 'encode'): H.load_module('entries', e).make(None, 'cpu')\n"
        "import roibasedimagecompression_torch.parallel.stream, roibasedimagecompression_torch.models.codec\n"
        "print(H.forbidden_loaded())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    with open(os.path.join(BENCH_DIR, "reference.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "hashlib", "io", "pickle", "struct", "zlib", "numpy",
                     "importlib"}
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('roibased')"
            " or m.split('.')[0] in ('jax', 'torch')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_exits_nonzero_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kodak768-lowlat.single",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark_files(tmp_path):
    """A directory that holds BENCHMARK.json and the benchmark's folder but
    not the program gives no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r); from portbench import run as R\n"
            "args = R.parse_args(['--workload', 'kodak768-lowlat.single', '--seed', '1',"
            " '--seconds', '1', '--trace', '0'])\n"
            "print(R.run(args, device='cpu'))\n" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "roibasedimagecompression_torch" in out.stderr
    assert "correct" not in out.stdout
