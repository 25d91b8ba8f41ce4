"""Runs of the benchmark on the card at the cells' own size, with short
windows: each cell is correct, and the control is not.  They skip without
a card: `python3 -m pytest portbench/tests/test_portbench_card.py` on the
card's machine runs them."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT, load_bench


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(workload, seed, *extra):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed),
         "--seconds", "2", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in load_bench()["workloads"]])
def test_cell_is_correct_on_the_card(workload):
    _card()
    res = _run(workload, 2**31 + 101)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_control_is_not_correct_on_the_card(seed):
    _card()
    res = _run("kodak768-lowlat.batch8", seed, "--control", "refit_off")
    assert not res["correct"]
    assert res["checks"]["refit_gap"]["value"] >= 1
