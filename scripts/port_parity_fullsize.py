#!/usr/bin/env python3
"""Hold the PyTorch port against the JAX package at full size, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/port_parity_fullsize.py [--rows a,b,...]
        [--work DIR] [--write-data tests/data/jax_parity_768x512.json]
        [--shape HxW] [--ids 100-107] [--write-digests CONFIG.digests.json]

Every row below encodes `utils/synthetic.py synthetic_image(seed, 512, 768)`
(Kodak's shape, the images `chip_smoke.py` encodes; `--shape` gives another,
`--ids` other seeds for every row run) through the JAX package
and through the port with `device="cpu"`, and compares the two by container
bytes and by the payload digest (`io/container.py payload_digest`, the same
reader for both packages' bytes).  Each side runs in a
child process of its own, one at a time (two processes on the same cores
slow both several times over); rows that read an environment variable get
it in the children's environment, as `chip_smoke.py --nonative-child` does.
The first encode of a child carries its compiles and first-use costs.

For each row and image the script prints whether the bytes are equal, the
digest on each side, the seconds on each side, whether the image has ROI
pixels (`roi_fused.roi_masks` of the port, or the loop's `roi.roi_masks` at
`batched=False`), and the largest weighted total of any k-means row of the
weighted split (ROADMAP §C11's line is 2^24 / 255 = 65,793 pixels).  Where a
row differs it runs `encode_debug` on both sides for that image and names
the first intermediate that differs.  Row k holds the JAX package's PSNR,
eager `ssim`, jitted `quality_metrics` and `ssim_map` of row b's decoded
images against the port's.

`--write-data` writes the JAX side's answers (digest, container length at
level 0, PSNR and SSIM) to the data file that `tests/test_torch_fullsize.py`
and `chip_smoke.py`'s parity phase read.  The whole table takes about half
an hour on an 8-core host; run it in the background.

`--write-digests` writes the JAX side's payload digests of the `encode_many`
rows run to a benchmark configuration's digests file (the shape of
`portbench/configs/*.digests.json`: `entries.encode_many`, id to digest,
with the JAX version and the CPU count): for example
`--rows b --shape 1365x2048 --ids 100-107 --write-digests
portbench/configs/clic2048-default.digests.json` (about 25 minutes on 8
cores).  The rows written must share one codec configuration, which has to
be the configuration file's `codec`.

This script imports JAX and the JAX package; the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from roibasedimagecompression_torch.io.container import payload_digest  # noqa: E402

H, W = 512, 768  # --shape sets them, in this process and in its children
C11_LINE = 2**24 // 255


@dataclasses.dataclass(frozen=True)
class Row:
    """One path: `encode` or `encode_many` at a config (keyword arguments of
    CodecConfig, or "low_latency"), with environment switches, over seeds.
    `enhance`: the image goes through `enhance_shadows` first, as the CLI's
    `--enhance-shadows` does.  `crop`: (y0, x0, h, w) of the image.  `shape`:
    (H, W), where the row runs at that shape only."""

    id: str
    path: str
    config: object
    seeds: tuple
    env: tuple = ()
    enhance: bool = False
    crop: tuple | None = None
    note: str = ""
    shape: tuple | None = None

    @property
    def group(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.env) or "plain"


# The CLI's default split margin is 2.0; CodecConfig()'s is 1.5.  Rows h*
# are the CLI's encodes (chip_smoke.py phase 9), so they take 2.0.
CLI = {"split_margin": 2.0}
ROWS = (
    Row("a", "encode", {}, (100, 101, 102)),
    Row("b", "encode_many", {}, tuple(range(100, 108))),
    Row("c", "encode_many", "low_latency", tuple(range(100, 108))),
    Row("d", "encode", {}, (100, 102), env=(("RHCCQ_SLIC_PALLAS", "1"),),
        note="the JAX Pallas kernel in interpret mode"),
    Row("e1", "encode", {"batched": False}, (100, 102)),
    Row("e2", "encode", {"batched": False, "single_region": True}, (100, 102)),
    Row("f1", "encode", {"region_fusion": True}, (100, 102)),
    Row("f2", "encode", {"weighted_split": True}, (100, 102)),
    Row("f3", "encode", {"batched": False, "region_fusion": True, "weighted_split": True}, (100, 102)),
    Row("g", "encode", {"weighted_split": True, "split_method": "kmeans"}, (100, 101, 102, 103)),
    Row("h0", "encode", dict(CLI), (101,), note="the CLI's defaults"),
    Row("h1", "encode", dict(CLI, split_method="mediancut"), (101, 102)),
    Row("h2", "encode", dict(CLI, split_method="kmeans-mc"), (101, 102)),
    Row("h3", "encode", dict(CLI), (101, 102), enhance=True, note="--enhance-shadows"),
    Row("i1", "encode", {}, (100, 101), env=(("RHCCQ_CANVAS_TIERS", "1"),)),
    Row("i2", "encode_many", {}, (100, 101, 102, 103), env=(("RHCCQ_CANVAS_TIERS", "1"),)),
    Row("i3", "encode", {"fill_black_holes": 10}, (100, 101)),
    Row("i4", "encode_many", {"fill_black_holes": 10}, (100, 101, 102, 103)),
    Row("j1", "encode", {}, (100, 102), env=(("RHCCQ_NATIVE", "0"),)),
    Row("j2", "encode_many", {}, (100, 101), env=(("RHCCQ_NATIVE", "0"),)),
    Row("j3", "encode", {"batched": False}, (100,), env=(("RHCCQ_NATIVE", "0"),)),
    # Crops for tier 1 (tests/test_torch_fullsize.py), where a whole 768x512
    # encode on one torch thread costs more than its budget.
    Row("a-crop", "encode", {}, (102,), crop=(64, 160, 256, 288),
        note="row a on a crop that holds ROI pixels"),
    Row("e1-crop", "encode", {"batched": False}, (102,), crop=(64, 160, 256, 288),
        note="row e on a crop that holds ROI pixels"),
    Row("g-crop", "encode", {"weighted_split": True, "split_method": "kmeans"}, (101,),
        crop=(0, 0, 288, 384), note="row g on a crop whose k-means rows cross 65,793 pixels"),
    # A crop of a CLIC-sized image whose tier 1 takes the uniform start
    # (k 269 of k_max 512 over 26,849 colours): tests/test_torch_fullsize.py.
    Row("b-crop", "encode_many", {}, (103,), crop=(0, 0, 720, 1040), shape=(1365, 2048),
        note="row b on a crop of a 1365x2048 image whose tier-1 k-means has k_max 512"),
)
ROW_IDS = tuple(r.id for r in ROWS)
METRICS_ROW = "k"


def row_image(seed: int, crop=None):
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    img = synthetic_image(seed, H, W)
    if crop is not None:
        y0, x0, h, w = crop
        img = img[y0 : y0 + h, x0 : x0 + w].copy()
    return img


def row_key(row: Row, seed: int) -> str:
    return f"{row.id}_{seed}"


# ---------------------------------------------------------------------------
# Children: one side, the rows of one environment group.
# ---------------------------------------------------------------------------

class Side:
    """The entry points of one package behind one interface."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import roibasedimagecompression_tpu as pkg
            from roibasedimagecompression_tpu.io import container
            from roibasedimagecompression_tpu.models import codec
            from roibasedimagecompression_tpu.models.enhance import enhance_shadows
            from roibasedimagecompression_tpu.ops import metrics
            from roibasedimagecompression_tpu.parallel import stream

            self.kw = {}
        else:
            import roibasedimagecompression_torch as pkg
            from roibasedimagecompression_torch.io import container
            from roibasedimagecompression_torch.models import codec
            from roibasedimagecompression_torch.models.enhance import enhance_shadows
            from roibasedimagecompression_torch.ops import metrics
            from roibasedimagecompression_torch.parallel import stream

            self.kw = {"device": "cpu"}
        self.pkg, self.container, self.codec = pkg, container, codec
        self.metrics, self.stream, self._enhance = metrics, stream, enhance_shadows

    def config(self, spec):
        if spec == "low_latency":
            return self.pkg.CodecConfig.low_latency()
        return self.pkg.CodecConfig(**spec)

    def enhance(self, img):
        return self._enhance(img, **self.kw)

    def encode(self, img, config):
        return self.pkg.encode(img, config, **self.kw)

    def encode_many(self, images, config):
        if self.name == "jax":
            return self.stream.encode_many(images, config)
        return self.stream.encode_many(images, config, "cpu")

    def encode_debug(self, img, config):
        return self.codec.encode_debug(img, config, **self.kw)


class WeightedTotals:
    """Records the largest weighted total of any k-means row that the port's
    `ops/cluster.py _weighted_sums` sees (and the row's point count)."""

    def __init__(self):
        from roibasedimagecompression_torch.ops import cluster

        self.cluster, self.inner = cluster, cluster._weighted_sums
        self.reset()

        def wrapped(labels, w, points, valid, k_max):
            totals = w.double().sum(dim=1)
            i = int(totals.argmax())
            if float(totals[i]) > self.max_total:
                self.max_total, self.m = float(totals[i]), int(points.shape[1])
            self.calls += 1
            return self.inner(labels, w, points, valid, k_max)

        cluster._weighted_sums = wrapped

    def reset(self):
        self.max_total, self.m, self.calls = 0.0, 0, 0


def has_roi(side: Side, img, row: Row) -> bool | None:
    """Whether the port's ROI masks hold a pixel (None: one region)."""
    spec = row.config if isinstance(row.config, dict) else {}
    config = side.config(row.config)
    if spec.get("single_region"):
        return None
    if not config.batched:
        from roibasedimagecompression_torch.models import roi

        return bool(roi.roi_masks(img, config, side.kw["device"])[0].any())
    from roibasedimagecompression_torch.models import roi_fused

    return bool(roi_fused.roi_masks(img, config, "cpu")[0].any())


def run_child(side_name: str, row_ids: list, work: str) -> int:
    """Run `row_ids` (one environment group) on one side; write one JSON
    record per row and seed and the containers under `work`."""
    import numpy as np

    side = Side(side_name)
    totals = WeightedTotals() if side_name == "port" else None
    out_dir = os.path.join(work, "bytes", side_name)
    os.makedirs(out_dir, exist_ok=True)
    records = {}
    for row in (r for r in ROWS if r.id in row_ids):
        config = side.config(row.config)
        images = [row_image(s, row.crop) for s in row.seeds]
        if row.enhance:
            images = [side.enhance(im) for im in images]
        if totals is not None:
            totals.reset()
        t0 = time.perf_counter()
        if row.path == "encode_many":
            datas = side.encode_many(images, config)
            secs = [(time.perf_counter() - t0) / len(images)] * len(images)
            shared = [None] * len(images)
            if totals is not None:
                shared = [(totals.max_total, totals.m)] * len(images)
        else:
            datas, secs, shared = [], [], []
            for img in images:
                t1 = time.perf_counter()
                if totals is not None:
                    totals.reset()
                datas.append(side.encode(img, config))
                secs.append(time.perf_counter() - t1)
                shared.append((totals.max_total, totals.m) if totals is not None else None)
        for seed, img, data, s, tot in zip(row.seeds, images, datas, secs, shared):
            key = row_key(row, seed)
            with open(os.path.join(out_dir, key + ".rhccq"), "wb") as f:
                f.write(data)
            decoded = side.container.unpack(data).to_rgb()
            q = side.metrics.quality_metrics(img, decoded, **side.kw)
            rec = {
                "row": row.id, "seed": seed, "seconds": s, "bytes_sha256": hashlib.sha256(data).hexdigest(),
                "digest": payload_digest(data),
                "container_len_level0": len(side.container.pack(
                    side.container.unpack(data).palette, side.container.unpack(data).indices, level=0)),
                "psnr": q["psnr"], "ssim": q["ssim"], "n_colors": int(side.container.unpack(data).n_colors),
                "image_sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            }
            if side_name == "port":
                rec["roi_pixels"] = has_roi(side, img, row)
                if tot is not None:
                    rec["weighted_max_total"], rec["weighted_m"] = tot
            records[key] = rec
            print(f"[{side_name}] {key}: {s:.1f} s, digest {rec['digest'][:12]}", flush=True)
    with open(os.path.join(work, f"{side_name}.{row_ids[0]}.json"), "w") as f:
        json.dump(records, f, indent=1)
    return 0


def run_debug_child(side_name: str, row_id: str, seed: int, work: str) -> int:
    """`encode_debug` of one row's image on one side: every intermediate to
    an .npz under `work`."""
    import numpy as np

    side = Side(side_name)
    row = next(r for r in ROWS if r.id == row_id)
    img = row_image(seed, row.crop)
    if row.enhance:
        img = side.enhance(img)
    dbg = side.encode_debug(img, side.config(row.config))
    payload = side.container.unpack(dbg.pop("data"))
    dbg["palette"], dbg["indices"] = payload.palette, payload.indices
    np.savez(os.path.join(work, f"debug.{side_name}.{row_id}_{seed}.npz"),
             **{k: np.asarray(v) for k, v in dbg.items()})
    return 0


def run_metrics_child(work: str, seeds) -> int:
    """Row k: PSNR, eager `ssim`, jitted `quality_metrics` and `ssim_map` of
    each of row b's JAX-decoded images against its original, on both sides."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from roibasedimagecompression_torch.io import container
    from roibasedimagecompression_torch.ops import metrics as TM
    from roibasedimagecompression_tpu.ops import metrics as JM

    out = {}
    for seed in seeds:
        img = row_image(seed)
        with open(os.path.join(work, "bytes", "jax", f"b_{seed}.rhccq"), "rb") as f:
            dec = container.unpack(f.read()).to_rgb()
        jq, tq = JM.quality_metrics(img, dec), TM.quality_metrics(img, dec, "cpu")
        je = float(JM.ssim(jnp.asarray(img), jnp.asarray(dec)))
        te = float(TM.ssim(torch.from_numpy(img), torch.from_numpy(dec)))
        jmap, tmap = JM.ssim_map(img, dec), TM.ssim_map(img, dec, device="cpu")
        out[str(seed)] = {
            "psnr_jax": jq["psnr"], "psnr_port": tq["psnr"],
            "ssim_jit_jax": jq["ssim"], "ssim_jit_port": tq["ssim"],
            "ssim_eager_jax": je, "ssim_eager_port": te,
            "d_psnr": abs(jq["psnr"] - tq["psnr"]),
            "d_ssim_jit": abs(jq["ssim"] - tq["ssim"]), "d_ssim_eager": abs(je - te),
            "d_map": float(np.abs(jmap.astype(np.float64) - tmap).max()),
            "map_pixels_differing": int(np.sum(jmap.view(np.uint32) != tmap.view(np.uint32))),
        }
        print(f"[metrics] {seed}: {json.dumps(out[str(seed)])}", flush=True)
    with open(os.path.join(work, "metrics.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


# ---------------------------------------------------------------------------
# The parent: children one at a time, then the comparison.
# ---------------------------------------------------------------------------

# Options every child gets from the parent: the shape and the ids.
CHILD_OPTIONS: list = []


def child(args: list, env: dict, log) -> None:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args, *CHILD_OPTIONS],
                          env=env, cwd=HERE,
                          capture_output=True, text=True)
    log.write(proc.stdout + proc.stderr)
    log.flush()
    if proc.returncode != 0:
        raise SystemExit(f"child {args} failed:\n{proc.stderr[-3000:]}")
    print(f"  child {' '.join(args[:3])} ... {time.perf_counter() - t0:.1f} s", flush=True)


def first_difference(row: Row, seed: int, work: str, env: dict, log) -> str:
    import numpy as np

    for side in ("jax", "port"):
        child(["--debug-child", side, row.id, str(seed), "--work", work], env, log)
    j = np.load(os.path.join(work, f"debug.jax.{row.id}_{seed}.npz"))
    t = np.load(os.path.join(work, f"debug.port.{row.id}_{seed}.npz"))
    for key in ("roi_mask", "nonroi_mask", "seg_map", "tier1", "tier2", "tier3", "palette", "indices"):
        if j[key].shape != t[key].shape or not np.array_equal(j[key], t[key]):
            n = int(np.sum(j[key] != t[key])) if j[key].shape == t[key].shape else -1
            return f"encode_debug: {key} ({n} elements differ)"
    return "encode_debug equal throughout (the difference is past its canvas path)"


def parse_ids(text: str) -> tuple:
    """"100-107" or "100,102,104" as a tuple of ints."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return tuple(out)


def set_shape_and_ids(shape: str, ids: str | None) -> None:
    """Set the image shape and, when given, every row's seeds, and hand both
    on to the children."""
    global H, W, ROWS
    H, W = (int(v) for v in shape.lower().split("x"))
    CHILD_OPTIONS[:] = ["--shape", f"{H}x{W}"]
    if ids is not None:
        ROWS = tuple(dataclasses.replace(r, seeds=parse_ids(ids)) for r in ROWS)
        CHILD_OPTIONS.extend(["--ids", ids])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default=",".join(ROW_IDS + (METRICS_ROW,)))
    p.add_argument("--work", default=os.path.join(HERE, "parity_out"))
    p.add_argument("--write-data", default=None)
    p.add_argument("--child", nargs=2, metavar=("SIDE", "ROWS"))
    p.add_argument("--debug-child", nargs=3, metavar=("SIDE", "ROW", "SEED"))
    p.add_argument("--metrics-child", action="store_true")
    p.add_argument("--shape", default=f"{H}x{W}", help="HxW of every image (default 512x768)")
    p.add_argument("--ids", default=None, help="seeds of every row run, as 100-107 or 100,102")
    p.add_argument("--write-digests", default=None, metavar="PATH")
    args = p.parse_args(argv)
    set_shape_and_ids(args.shape, args.ids)
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    if args.child:
        return run_child(args.child[0], args.child[1].split(","), work)
    if args.debug_child:
        side, row_id, seed = args.debug_child
        return run_debug_child(side, row_id, int(seed), work)
    metrics_seeds = next(r for r in ROWS if r.id == "b").seeds
    if args.metrics_child:
        return run_metrics_child(work, metrics_seeds)

    wanted = args.rows.split(",")
    rows = [r for r in ROWS if r.id in wanted and r.shape in (None, (H, W))]
    groups = {}
    for r in rows:
        groups.setdefault(r.group, []).append(r)
    base_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RHCCQ_SLIC_PALLAS", "RHCCQ_CANVAS_TIERS", "RHCCQ_NATIVE"):
        base_env.pop(k, None)
    log = open(os.path.join(work, "children.log"), "a")
    t_all = time.perf_counter()
    results = {}
    for group, members in groups.items():
        env = dict(base_env, **dict(members[0].env))
        ids = ",".join(r.id for r in members)
        print(f"group {group}: rows {ids}", flush=True)
        for side in ("jax", "port"):
            child(["--child", side, ids, "--work", work], env, log)
        with open(os.path.join(work, f"jax.{members[0].id}.json")) as f:
            jrec = json.load(f)
        with open(os.path.join(work, f"port.{members[0].id}.json")) as f:
            trec = json.load(f)
        for row in members:
            for seed in row.seeds:
                key = row_key(row, seed)
                j, t = jrec[key], trec[key]
                rec = {"row": row.id, "path": row.path, "config": row.config, "env": dict(row.env),
                       "enhance": row.enhance, "crop": row.crop, "seed": seed,
                       "bytes_equal": j["bytes_sha256"] == t["bytes_sha256"],
                       "digest_equal": j["digest"] == t["digest"], "jax": j, "port": t}
                if not rec["digest_equal"]:
                    rec["first_difference"] = first_difference(row, seed, work, env, log)
                results[key] = rec
                c11 = t.get("weighted_max_total", 0) or 0
                print(f"  {key}: bytes {'equal' if rec['bytes_equal'] else 'DIFFER'}, digest "
                      f"{'equal' if rec['digest_equal'] else 'DIFFERS'} ({j['digest'][:12]} / {t['digest'][:12]}); "
                      f"{j['seconds']:.1f} s JAX, {t['seconds']:.1f} s port; ROI pixels {t['roi_pixels']}; "
                      f"largest weighted k-means row {c11:.0f} at m = {t.get('weighted_m', 0)}"
                      f"{' (above 65,793)' if c11 > C11_LINE else ''}"
                      + (f"; first difference: {rec['first_difference']}" if 'first_difference' in rec else ""),
                      flush=True)
    if METRICS_ROW in wanted:
        print("row k: metrics of row b's decoded images", flush=True)
        child(["--metrics-child", "--work", work], base_env, log)
        with open(os.path.join(work, "metrics.json")) as f:
            results[METRICS_ROW] = json.load(f)
    with open(os.path.join(work, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    if args.write_data:
        write_data(args.write_data, results)
    if args.write_digests:
        write_digests(args.write_digests, results)
    n = sum(1 for k, r in results.items() if k != METRICS_ROW)
    eq = sum(1 for k, r in results.items() if k != METRICS_ROW and r["digest_equal"])
    print(f"{eq} of {n} encodes equal by payload digest; {time.perf_counter() - t_all:.0f} s in all")
    return 0


def write_digests(path: str, results: dict) -> None:
    """The JAX side's payload digests of the `encode_many` rows run, as a
    benchmark configuration's digests file."""
    import jax

    rows = [r for k, r in results.items() if k != METRICS_ROW and r["path"] == "encode_many"]
    if not rows:
        raise SystemExit("--write-digests: no encode_many row was run")
    if len({json.dumps(r["config"]) for r in rows}) != 1:
        raise SystemExit("--write-digests: the encode_many rows run have different configurations")
    ids = sorted({r["seed"] for r in rows})
    doc = {
        "about": f"Payload digests (portbench/reference.py digest) of the JAX package's encodes of "
                 f"synthetic_image(id, {H}, {W}), ids {ids[0]}-{ids[-1]}, on an {os.cpu_count()}-core "
                 f"CPU host: encode_many of the set in id order, written by "
                 f"scripts/port_parity_fullsize.py --write-digests. Data only.",
        "cpu_count": os.cpu_count(),
        "jax": jax.__version__,
        "entries": {"encode_many": {str(r["seed"]): r["jax"]["digest"]
                                    for r in sorted(rows, key=lambda r: r["seed"])}},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {len(rows)} digests to {path}")


def write_data(path: str, results: dict) -> None:
    """The JAX side's answers, one entry per row and seed."""
    import jax
    import jaxlib

    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = {(e["row"], e["seed"]): e for e in json.load(f)["entries"]}
    for key, r in results.items():
        if key == METRICS_ROW:
            continue
        j = r["jax"]
        old[(r["row"], r["seed"])] = {
            "row": r["row"], "path": r["path"], "config": r["config"], "env": r["env"],
            "enhance": r["enhance"], "crop": r["crop"], "seed": r["seed"],
            "digest": j["digest"], "container_len_level0": j["container_len_level0"],
            "n_colors": j["n_colors"], "psnr": round(j["psnr"], 7), "ssim": round(j["ssim"], 7),
            "port_roi_pixels": r["port"]["roi_pixels"],
        }
    order = {rid: i for i, rid in enumerate(ROW_IDS)}
    entries = sorted(old.values(), key=lambda e: (order.get(e["row"], 99), e["seed"]))
    doc = {
        "about": f"The JAX package's answers on synthetic_image(seed, {H}, {W}) (crop: (y0, x0, h, w) of "
                 "it), written by scripts/port_parity_fullsize.py from the JAX side, all but "
                 "port_roi_pixels.  digest: sha256 of the unpacked palette's bytes, the index matrix's "
                 "bytes and repr of its shape; container_len_level0: the payload packed at "
                 "container_level=0 (zlib 9); psnr, ssim: the JAX package's quality_metrics of the "
                 "decoded image against the encoded one.  port_roi_pixels: whether the port's ROI masks "
                 "of the image hold a pixel (computed by the port, not the JAX package; null where the "
                 "row runs as one region).",
        "jax": jax.__version__, "jaxlib": jaxlib.__version__, "cpu_count": os.cpu_count(),
        "shape": [H, W], "entries": entries,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {len(entries)} entries to {path}")


if __name__ == "__main__":
    sys.exit(main())
