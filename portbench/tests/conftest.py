"""Shared helpers of the benchmark's own tests (CPU, small images)."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def bench():
    return load_bench()


@pytest.fixture
def tiny_bench(tmp_path):
    """BENCHMARK.json with every configuration cut to a tiny image set in
    `tmp_path` (the same codec settings), for runs on the CPU."""
    b = load_bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        spec["images"] = {"generator": "synthetic_image", "height": 64, "width": 80,
                          "ids": list(range(5, 15))}
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(spec))
        c["file"] = str(path)
    return b
