#!/usr/bin/env python3
"""Time design variants of the port's two CUDA kernels on one NVIDIA card, and
count the instructions of their inner loops.

    python3 scripts/port_kernel_variants.py

Each variant is the committed source under
`roibasedimagecompression_torch/csrc/` with one or two constants or lines
replaced by text substitution (the substitution fails loudly when the source
has moved on).  All variants are compiled at once (one nvcc each) into the
git-ignored `_proof/build/`, launched directly through ctypes on preallocated
tensors, and timed by CUDA events over 50 launches, twice over, at the shapes
`chip_smoke.py` uses.  The output says which choices of the committed kernels
were measured against what: pixels or rows per thread, threads per block,
unroll depth, the predicated minimum against the select-then-minimum, what
the group compare costs (`nogroup` gives wrong labels for rows with two
groups; it is there for its time only), and what the far-tile skip of the loop
kernel saves (`noskip`) on sorted rows and on the packed rows of the tiers.

For the committed kernels it also prints, from `cuobjdump -sass` of the built
library, the opcodes of the innermost loop that holds the pair arithmetic, and
their number per pair test.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
OUT = os.path.join(HERE, "_proof", "build")
P, I = ctypes.c_void_p, ctypes.c_int

SLIC_VARIANTS = {
    "committed": [],
    "pix8": [("constexpr int kPix = 4;", "constexpr int kPix = 8;")],
    "pix2": [("constexpr int kPix = 4;", "constexpr int kPix = 2;")],
    "unroll4": [("#pragma unroll 2\n  for (int c = 0", "#pragma unroll 4\n  for (int c = 0")],
    "unroll1": [("#pragma unroll 2\n  for (int c = 0", "#pragma unroll 1\n  for (int c = 0")],
    "threads128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
}
_SELMIN = "best[r] = min(best[r], (d2 <= e2 && (G) == gr[r]) ? (L) : INT32_MAX);"
EPS_VARIANTS = {
    "committed": [],
    "predicated": [(_SELMIN, "if (d2 <= e2 && (G) == gr[r]) best[r] = min(best[r], (L));       ")],
    "nogroup": [(_SELMIN, "best[r] = min(best[r], (d2 <= e2) ? (L) : INT32_MAX);                ")],
    "threads256rows2": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
                        ("constexpr int kRows = 4; ", "constexpr int kRows = 2; ")],
    "threads64rows8": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
                       ("constexpr int kRows = 4; ", "constexpr int kRows = 8; ")],
    "unroll1": [("#pragma unroll 2\n  for (int v = 0", "#pragma unroll 1\n  for (int v = 0")],
    "unroll4": [("#pragma unroll 2\n  for (int v = 0", "#pragma unroll 4\n  for (int v = 0")],
    "noskip": [("if (run) {  // far-tile skip", "if (false) {  // far-tile skip")],
}


def compile_variants(name: str, variants: dict) -> dict:
    """{variant: (path of its library, ctypes handle)}."""
    from roibasedimagecompression_torch.ops.cuda import _build

    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    procs = {}
    for vname, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}/{vname}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}_{vname}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}_{vname}.so")
        procs[vname] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, path, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    libs = {}
    for vname, (so, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name}/{vname}: nvcc failed\n{out.decode()[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", out.decode())
        print(f"[build] {name}/{vname}: registers per kernel {regs}", flush=True)
        libs[vname] = (so, ctypes.CDLL(so))
    return libs


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*(.*?);")


def inner_loop_opcodes(so: str, kernel: str, pair_op: str) -> None:
    """Print the opcode counts of `kernel`'s innermost loop holding `pair_op`
    (one per pair test), from `cuobjdump -sass` of the library `so`."""
    from roibasedimagecompression_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        print(f"[sass] {kernel}: cuobjdump not found, no instruction counts", flush=True)
        return
    run = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        print(f"[sass] {kernel}: cuobjdump failed: {run.stderr[-300:]}", flush=True)
        return
    body = [part for part in run.stdout.split("Function : ")[1:] if kernel in part.split("\n", 1)[0]]
    if not body:
        print(f"[sass] {kernel}: no such function in the library", flush=True)
        return
    # Instructions in order, and the address each label stands before
    # (cuobjdump names a branch target by address or by a `.L_x_n` label).
    ins, label_at, waiting = [], {}, []
    for line in body[0].splitlines():
        label = re.match(r"\s*(\.L\w+):", line)
        m = _SASS_LINE.search(line)
        if label:
            waiting.append(label[1])
        elif m:
            ins.append((int(m[1], 16), m[2], m[4]))
            for name in waiting:
                label_at[name] = ins[-1][0]
            waiting = []
    loops = []
    for addr, op, rest in ins:
        if op != "BRA":
            continue
        by_addr, by_label = re.search(r"0x([0-9a-f]+)", rest), re.search(r"(\.L\w+)", rest)
        target = int(by_addr[1], 16) if by_addr else label_at.get(by_label[1]) if by_label else None
        if target is not None and target <= addr:
            inside = [o for a, o, _ in ins if target <= a <= addr]
            if pair_op in inside:
                loops.append(inside)
    if not loops:
        print(f"[sass] {kernel}: found no backward branch around {pair_op}; whole kernel: "
              f"{dict(collections.Counter(o for _, o, _ in ins))}", flush=True)
        return
    inner = min(loops, key=len)
    pairs = inner.count(pair_op)
    print(f"[sass] {kernel}: innermost loop with {pair_op}: {len(inner)} instructions for {pairs} "
          f"pair tests = {len(inner) / pairs:.3f} a pair; {dict(collections.Counter(inner).most_common())}",
          flush=True)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("port_kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    card = cs.card_line()
    cuda = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    slibs = compile_variants("slic_assign", SLIC_VARIANTS)
    elibs = compile_variants("epscc", EPS_VARIANTS)
    inner_loop_opcodes(slibs["committed"][0], "slic_assign_kernel", "FSETP")
    inner_loop_opcodes(elibs["committed"][0], "eps_sweep_kernel", "IDP")

    feats, centers = cs.slic_inputs(cuda)
    b, mp, k = feats.shape[0], feats.shape[1], centers.shape[1]
    out = torch.empty((b, mp), dtype=torch.int32, device=cuda)
    want = None
    for _ in range(2):
        for vname, (_, lib) in slibs.items():
            lib.slic_assign_launch.argtypes = [P, P, P, I, I, I, P]
            lib.slic_assign_launch.restype = I
            ms = cs.time_cuda(lambda: lib.slic_assign_launch(
                feats.data_ptr(), centers.data_ptr(), out.data_ptr(), b, mp, k, stream()), 50, 3)
            want = out.clone() if want is None else want
            print(f"[slic_assign] {vname} B,MP,K={(b, mp, k)}: {ms:.4f} ms, "
                  f"ids equal the committed kernel's: {bool((out == want).all())} [{card}]", flush=True)

    for vname, (_, lib) in elibs.items():
        lib.eps_pack_launch.argtypes = [P, P, P, P, P, P, P, P, I, P, I, I, P]
        lib.eps_sweep_launch.argtypes = [P, P, P, P, P, P, I, I, P]
        lib.eps_components_launch.argtypes = [P, P, P, P, P, I, I, P]
        lib.eps_pack_launch.restype = lib.eps_sweep_launch.restype = I
        lib.eps_components_launch.restype = I
    for b, n in ((64, 1024), (16, 4096), (4, 10240)):
        for full in (False, True):
            pts, valid, groups, eps2, _ = cs.eps_inputs(cuda, b, n)
            if full:  # every point valid, one group: all n^2 pairs are tested
                valid, groups = torch.ones_like(valid), torch.zeros_like(groups)
            v8 = valid.to(torch.uint8)
            lab0 = torch.where(valid, torch.arange(n, dtype=torch.int32, device=cuda).expand(b, n),
                               torch.full((b, n), 2**31 - 1, dtype=torch.int32, device=cuda)).contiguous()
            for vname, (_, lib) in elibs.items():
                if vname == "noskip":
                    continue
                packed, gcol, fill = torch.empty((3, b, n), dtype=torch.int32, device=cuda)
                meta = torch.empty(4 * b + 4, dtype=torch.int32, device=cuda)
                pack = lambda: lib.eps_pack_launch(
                    pts.data_ptr(), None, v8.data_ptr(), groups.data_ptr(), eps2.data_ptr(),
                    packed.data_ptr(), gcol.data_ptr(), fill.data_ptr(), 0, meta.data_ptr(), b, n, stream())
                sweep = lambda: lib.eps_sweep_launch(
                    packed.data_ptr(), groups.data_ptr(), gcol.data_ptr(), lab0.data_ptr(),
                    fill.data_ptr(), meta.data_ptr(), b, n, stream())
                if pack() != 0 or sweep() != 0:
                    raise SystemExit(f"epscc/{vname}: a launch failed")
                print(f"[eps_sweep] {vname} B,N={(b, n)} {'full' if full else 'ragged, 2 groups'}: "
                      f"pack {cs.time_cuda(pack, 50, 3):.4f} ms, sweep {cs.time_cuda(sweep, 50, 3):.4f} ms "
                      f"[{card}]", flush=True)

    # The loop kernel with and without the far-tile skip: pack + loop, by CUDA
    # events (no read-back), on rows of packed colours.
    rows_np, _, eps = cs.packed_eps_inputs(7, 9999)
    cases = {"tiers' packed rows, clumps, mixed eps": (rows_np, eps.astype(np.float32) ** 2)}
    for q_eps in (64.0, 12.8):
        rng = np.random.default_rng(1)
        srt = np.stack([np.sort(rng.choice(1 << 24, 10240, replace=False)) for _ in range(4)]).astype(np.int32)
        cases[f"uniform colours sorted by packed value, eps {q_eps}"] = (srt, np.full(4, np.float32(q_eps) ** 2))
    for what, (rows_np, eps2_np) in cases.items():
        b, n = rows_np.shape
        rows = torch.from_numpy(rows_np).to(cuda)
        eps2 = torch.from_numpy(eps2_np.astype(np.float32)).to(cuda)
        labels = {}
        for _ in range(2):
            for vname in ("committed", "noskip"):
                lib = elibs[vname][1]
                packed, gcol, lab = torch.empty((3, b, n), dtype=torch.int32, device=cuda)
                meta = torch.empty(4 * b + 4, dtype=torch.int32, device=cuda)
                boxes = torch.empty((b, -(-n // 256), 2), dtype=torch.int32, device=cuda)

                def call():
                    rc = lib.eps_pack_launch(None, rows.data_ptr(), None, None, eps2.data_ptr(),
                                             packed.data_ptr(), gcol.data_ptr(), lab.data_ptr(), 1,
                                             meta.data_ptr(), b, n, stream())
                    rc = rc or lib.eps_components_launch(packed.data_ptr(), gcol.data_ptr(), lab.data_ptr(),
                                                         meta.data_ptr(), boxes.data_ptr(), b, n, stream())
                    if rc != 0:
                        raise SystemExit(f"epscc/{vname}: a launch failed with {rc}")

                ms = cs.time_cuda(call, 50, 3)
                labels[vname] = lab.clone()
                rounds = int(meta.cpu()[3 : 4 * b : 4].max()) + 2
                print(f"[eps_loop] {vname} B,N={(b, n)} {what}: pack + loop {ms:.4f} ms, {rounds} rounds "
                      f"[{card}]", flush=True)
        print(f"[eps_loop] labels with and without the skip equal: "
              f"{bool((labels['committed'] == labels['noskip']).all())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
