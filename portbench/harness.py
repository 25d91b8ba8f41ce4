"""The benchmark's machinery, driven by names: `BENCHMARK.json` names a cell,
the cell names a configuration (`configs/<config>.json`, with its reference
digests beside it in `configs/<config>.digests.json`) and a traffic mix
(`traffic/<mix>.json`, which names its driver `drivers/<driver>.py` and the
entry point `entries/<entry>.py` it drives); every metric but `setup_s` is
read by `metrics/<name>.py`, or `metrics/<base>.py` for a name
`<base>.<suffix>`.  A new cell, mix or metric is new files plus entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "roibasedimagecompression_tpu")
# Every number compared, with its limit: all four are exact.
LIMITS = {"unanswered": 0, "malformed": 0, "digest_differs": 0, "refit_gap": 0}
# The control: the program's own switch that breaks the refit guarantee the
# configurations state (palette_refit is on in both).
CONTROLS = {"refit_off": {"palette_refit": False}}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """`<base>/<kind>/<name>.py` as a module, or None if there is none."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE):
    """The reader of metric `name`: `metrics/<name>.py`, else
    `metrics/<stem>.py` for `<stem>.<suffix>`; (module, suffix)."""
    mod = load_module("metrics", name, base)
    if mod is not None:
        return mod, None
    stem, _, suffix = name.partition(".")
    mod = load_module("metrics", stem, base)
    if mod is None:
        raise FileNotFoundError(f"no reader for metric {name} under portbench/metrics/")
    return mod, suffix or None


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json, resolved to its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    digests: dict | None
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, base: str = HERE) -> Cell:
    """The files of cell `workload`, under the benchmark's folder `base`
    (configuration files are named from the checkout's root, its parent)."""
    root = os.path.dirname(base)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    dpath = os.path.join(root, cfg_entry["file"][: -len(".json")] + ".digests.json")
    digests = load_json(dpath) if os.path.exists(dpath) else None
    return Cell(workload, int(w["chips"]), config, traffic, digests,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def requests(order: list, images: dict, batch: int, start: int = 0):
    """Endless requests of `batch` ids each, cycling through `order` from
    position `start`; yields (ids, images)."""
    n = len(order)
    for i in itertools.count():
        ids = [order[(start + i * batch + j) % n] for j in range(batch)]
        yield ids, [images[k] for k in ids]


def codec_config(cell: Cell, control: str | None):
    from roibasedimagecompression_torch import config as cfg

    overrides = dict(cell.config["codec"])
    if control is not None:
        overrides.update(CONTROLS[control])
    return cfg.CodecConfig(**overrides)


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that no run may hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def check_answers(records: list, images: dict, digests: dict | None, entry: str) -> dict:
    """The reference's readings over every answer of `records`: the numbers
    compared (each beside its limit), and `failed`, the images of the
    window's records (`in_window`) whose answer never came or could not be
    read."""
    from portbench import reference as REF

    table = (digests or {}).get("entries", {}).get(entry, {})
    unanswered = malformed = differs = gap = failed = 0
    for rec in records:
        answers = rec["answers"]
        counted = 1 if rec.get("in_window") else 0
        if answers is None or len(answers) != len(rec["ids"]):
            unanswered += len(rec["ids"])
            failed += counted * len(rec["ids"])
            continue
        for k, data in zip(rec["ids"], answers):
            r = REF.judge(images[k], data, table.get(str(k)))
            malformed += r["malformed"]
            failed += counted * r["malformed"]
            differs += r["digest_differs"]
            if r["refit_gap"] is not None:
                gap = max(gap, r["refit_gap"])
    checks = {"unanswered": unanswered, "malformed": malformed, "digest_differs": differs,
              "refit_gap": gap}
    return {"checks": {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()},
            "failed": failed}


def stage_ms_per_image(ctx, names) -> float | None:
    """Milliseconds per image of the window spent in the stages `names`
    (`utils/timing.py` host wall clock; each stage ends in a host copy, so
    its device work is inside).  0 where none of them ran; None without
    images."""
    if not ctx.images:
        return None
    return 1e3 * sum(ctx.stages.get(n, {}).get("seconds", 0.0) for n in names) / ctx.images
