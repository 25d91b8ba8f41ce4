"""A run on the CPU at a tiny size, through everything but the look for a
card, with the timed path broken underneath: `correct` has to come out
false for each fault the cells can have, and for the control.

The digests the check holds these tiny answers against are harvested from
a sound run of the program in the test itself: what is under test here is
that the check sees each fault, not the program's bytes (the cells' own
digests come from the JAX package)."""

from __future__ import annotations

import json
import pickle
import struct
import time
import zlib

import numpy as np
import pytest

from portbench import reference as REF
from portbench import run as R


def _run(bench, workload, wrap_call=None, control=None, seed=2**31 + 11):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.01", "--trace", "0"]
    if control:
        argv += ["--control", control]
    return R.run(R.parse_args(argv), device="cpu", t_start=time.perf_counter(), bench=bench,
                 wrap_call=wrap_call)


def _with_digests(bench, workload):
    """Encode the tiny set once with the cell's entry point and write the
    digests beside the tiny configuration's file."""
    from portbench import harness as H
    from portbench import images as IM

    cell = H.resolve(bench, workload)
    imgs = IM.image_set(cell.config["images"])
    entry = cell.traffic["entry"]
    call = H.load_module("entries", entry).make(H.codec_config(cell, None), "cpu")
    ids = sorted(imgs)
    table = {}
    for k, data in zip(ids, call([imgs[k] for k in ids])):
        pal, idx, _ = REF.parse(data)
        table[str(k)] = REF.digest(pal, idx)
    cfg_file = {c["name"]: c for c in bench["configs"]}[cell.config["name"]]["file"]
    with open(cfg_file[: -len(".json")] + ".digests.json", "w") as f:
        json.dump({"entries": {entry: table}}, f)
    return table


def _repack(data: bytes, edit) -> bytes:
    """The container with its index matrix edited, written in the same format."""
    (size,) = struct.unpack("<I", data[5:9])
    payload = pickle.loads(zlib.decompress(data[9:9 + size]))
    idx = np.frombuffer(zlib.decompress(payload["i"]), payload["d"]).copy()
    edit(idx, int(payload["l"]))
    payload["i"] = zlib.compress(idx.tobytes(), 9)
    blob = zlib.compress(pickle.dumps(payload, protocol=5), 9)
    return REF.MAGIC + struct.pack("<I", len(blob)) + blob


def stale(call):
    """A step that returns its state unchanged: the previous answers again."""
    last = []

    def wrapped(images):
        out = call(images) if not last else last[-1]
        last.append(out)
        return out[: len(images)] if len(out) >= len(images) else out * len(images)
    return wrapped


def half_left_out(call):
    """Half of the batch left out; the answers of the rest stand in for it."""
    def wrapped(images):
        half = call(images[: max(1, len(images) // 2)])
        return (half * len(images))[: len(images)]
    return wrapped


def index_altered(call):
    """One pixel's index altered where the answer is produced."""
    def wrapped(images):
        out = list(call(images))

        def edit(idx, n):
            idx[len(idx) // 2] = (int(idx[len(idx) // 2]) + 1) % n
        out[0] = _repack(out[0], edit)
        return out
    return wrapped


def truncated(call):
    """An answer cut short where it is produced: the reader cannot parse it."""
    def wrapped(images):
        out = list(call(images))
        out[0] = out[0][: len(out[0]) // 2]
        return out
    return wrapped


def answers_dropped(call):
    """A request that returns fewer answers than it was given images."""
    def wrapped(images):
        return call(images)[:-1]
    return wrapped


@pytest.mark.parametrize("workload", ["kodak768-lowlat.batch8", "kodak768-lowlat.single"])
def test_sound_run_is_correct_and_each_fault_is_not(tiny_bench, workload):
    table = _with_digests(tiny_bench, workload)
    assert len(table) == 10
    sound = _run(tiny_bench, workload, seed=12345)
    assert sound["correct"], sound["checks"]
    assert all(c["value"] == 0 for c in sound["checks"].values())
    # Each fault, and the numbers compared that read it above their limit of 0.
    faults = [(stale, ("digest_differs", "refit_gap")), (index_altered, ("digest_differs",)),
              (truncated, ("malformed",)), (answers_dropped, ("unanswered",))]
    if workload.endswith("batch8"):
        faults.append((half_left_out, ("digest_differs", "refit_gap")))
    for fault, numbers in faults:
        res = _run(tiny_bench, workload, wrap_call=fault)
        assert not res["correct"], (fault.__name__, res["checks"])
        assert all(res["checks"][n]["value"] > 0 for n in numbers), (fault.__name__, res["checks"])


def test_control_is_not_correct(tiny_bench):
    """The program with its palette refit off, the guarantee both
    configurations state, fails the refit law and the digests."""
    _with_digests(tiny_bench, "kodak768-lowlat.batch8")
    res = _run(tiny_bench, "kodak768-lowlat.batch8", control="refit_off")
    assert not res["correct"]
    assert res["checks"]["refit_gap"]["value"] >= 1
    assert res["checks"]["digest_differs"]["value"] >= 1
