#!/usr/bin/env python3
"""Two probes of the batch path, for the card.

    python3 scripts/port_stream_probe.py          # stream workers
    python3 scripts/port_stream_probe.py pairs    # pair-table forms

**Stream workers**: why two are not faster than one.  Encodes 3 batches of 8 synthetic 768x512 images on the card, in turns:
sequential `encode_many`, `encode_stream(workers=2)` at the interpreter's
default thread switch interval (5 ms), and `encode_stream(workers=2)` at a
0.1 ms interval; each arm twice.  A batch is thousands of small launches and
device reads made from Python: a worker that comes back from a device read
has to wait for the other worker to give up the interpreter lock, which it
does once per switch interval.  If the short interval closes the gap, that
wait is what the stream loses.  Prints seconds per arm and the card line;
checks that every arm writes the same bytes.

**Pair-table forms**: the JAX package downloads the device pair table packed
into two 32-bit words a row (8 bytes) where segment ids and counts fit, and as
three words (12 bytes) otherwise.  The port keeps the three-word form only;
this probe holds the two-word form (a copy of it lives here, not in the
package) against it on the tall map of 8 synthetic 768x512 images: compact,
read-back and host unpack, by the host clock around a synchronised call, in
turns.  Checks that both give the same table.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def probe_pair_forms() -> int:
    import ctypes
    import statistics

    import numpy as np
    import torch

    from roibasedimagecompression_torch import config as cfg
    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops import pairs as PAIRS
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import device as DEV
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    device, card = DEV.resolve(None), card_line()
    batch = np.stack([synthetic_image(100 + i, 512, 768) for i in range(8)])
    tall_seg, _, _, _, dbatch = STREAM._segment_stack(batch, cfg.CodecConfig(), device)
    seg_flat = torch.from_numpy(tall_seg.reshape(-1)).to(device)
    key_s, _, new, pair_id, n_pairs, n_valid = PAIRS._pair_sort(seg_flat, dbatch.img.reshape(-1, 3))
    cap = PAIRS._pow2(n_pairs, minimum=4096)
    unpack_u32 = native.get_lib().unpack_pair_table_u32
    unpack_u32.restype = None
    unpack_u32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]

    def wide():
        table, _ = PAIRS._pair_compact(key_s, new, pair_id, n_valid, n_pairs, cap=cap)
        return native.unpack_pair_table(table[:n_pairs].cpu().numpy())

    def packed():
        # a = seg << 16 | count_lo16, b = count_hi8 << 24 | col24
        out_seg, out_col, counts = PAIRS._compact_rows(key_s, new, pair_id, n_valid, cap)
        PAIRS._post_repair_colors(out_seg, out_col, n_pairs, cap)
        table = torch.stack([(out_seg << 16) | (counts & 0xFFFF),
                             ((counts >> 16) << 24) | out_col], dim=1)
        host = np.ascontiguousarray(table[:n_pairs].cpu().numpy())
        uniq, cnt = np.empty(n_pairs, np.int64), np.empty(n_pairs, np.int64)
        unpack_u32(host.ctypes.data, n_pairs, uniq.ctypes.data, cnt.ctypes.data)
        return uniq, cnt

    if not all(np.array_equal(a, b) for a, b in zip(wide(), packed())):
        print("port_stream_probe: FAILED: the two table forms differ", file=sys.stderr)
        return 1
    times = {"wide (12 bytes a row)": [], "packed (8 bytes a row)": []}
    for _ in range(10):
        for name, fn in (("wide (12 bytes a row)", wide), ("packed (8 bytes a row)", packed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        print(f"[pair_forms] {n_pairs} pairs, compact + read-back + unpack, {name}: median "
              f"{statistics.median(ts):.3f} ms, min {min(ts):.3f}, max {max(ts):.3f} "
              f"(host clock, 10 calls in turns) [{card}]")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_stream_probe: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["pairs"]:
        return probe_pair_forms()
    from roibasedimagecompression_torch.parallel import stream as STREAM
    from roibasedimagecompression_torch.utils import device as DEV
    from roibasedimagecompression_torch.utils.synthetic import synthetic_image

    device = DEV.resolve(None)
    card = card_line()
    batches = [[synthetic_image(100 + 8 * k + i, 512, 768) for i in range(8)] for k in range(3)]
    want = [STREAM.encode_many(bt, None, device) for bt in batches]  # warm-up
    default_interval = sys.getswitchinterval()

    def sequential():
        return [STREAM.encode_many(bt, None, device) for bt in batches]

    def stream():
        return STREAM.encode_stream(batches, None, 2, device)

    arms = [("sequential", sequential, default_interval),
            ("stream workers=2, switch interval 5 ms", stream, default_interval),
            ("stream workers=2, switch interval 0.1 ms", stream, 1e-4)]
    try:
        for turn in range(2):
            for name, fn, interval in arms:
                sys.setswitchinterval(interval)
                t0 = time.perf_counter()
                got = fn()
                seconds = time.perf_counter() - t0
                if got != want:
                    print(f"port_stream_probe: FAILED: {name} wrote other bytes", file=sys.stderr)
                    return 1
                print(f"[stream_probe] turn {turn}: {name}: {seconds:.3f} s, "
                      f"{24 / seconds:.3f} images/s [{card}]", flush=True)
    finally:
        sys.setswitchinterval(default_interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
