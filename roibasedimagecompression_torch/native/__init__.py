"""ctypes bindings for the host C++ runtime (rhccq_native.cpp).

The source is a byte-identical copy of the JAX package's runtime (a test pins
its hash).  It is compiled with g++ at first use into the package's `_build/`
directory, under a name that carries the source hash.

`RHCCQ_NATIVE=0` (read once per process, as the JAX package reads it) turns
the runtime off: `available()` is False and every entry point returns None
(or False, or runs its numpy branch where the JAX package's wrapper has one),
so each caller takes the JAX package's own branch without the runtime, and
writes the JAX package's bytes under the same switch.  Without the switch a
runtime that fails to build or load raises: the port never slides onto those
branches by itself (the JAX package does, quietly).

libdeflate is loaded from the system (`libdeflate.so.0`, `libdeflate.so`,
`libdeflate.so.1`, in that order); without it, container levels 1-12 fall back
to zlib level 9, as the JAX package's host code does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "rhccq_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

# name -> (restype, argtypes) for every function this package calls.
_SIGNATURES = {
    "rle_encode_u16": (_I64, [_P, _I64, _P]),
    "rle_decode_u16": (_I64, [_P, _I64, _P, _I64]),
    "cc_label": (_I32, [_P, _I32, _I32, _I32, _P, _P]),
    "component_stats": (None, [_P, _I64, _I64, _I32, _P, _P]),
    "slic_enforce": (_I32, [_P, _P, _I32, _I32, _I32, _P]),
    "roi_pipeline": (None, [_P, _I32, _I32, _P, _P, _P, _P]),
    "canny_analysis": (None, [_P, _I32, _I32, _P, _P, _P, _P]),
    "gradient_nms_rgb": (None, [_P, _I32, _I32, _P, _P]),
    "score_candidates": (_I32, [_P, _P, _P, _I32, _I32, _P, _I32]),
    "sort_unique_inverse": (_I64, [_P, _I64, _P, _P, _P]),
    "argsort_i64": (None, [_P, _I64, _P]),
    "pack_pairs": (_I64, [_P, _P, _I64, _P, _P, _P]),
    "black_repair_pairs": (_I64, [_P, _P, _I64, _P, _I64, _P]),
    "unpack_pair_table_i32": (None, [_P, _I64, _P, _P]),
    "split_pair_uniq": (None, [_P, _I64, _P, _P, _P]),
    "cluster_means_u8": (None, [_P, _P, _P, _I64, _I64, _P]),
    "paint_masked_indices": (None, [_P, _P, _P, _I64, _I32, _P]),
    "paint_masked_colors": (None, [_P, _P, _P, _P, _I64, _P]),
    "pack_sel": (_I64, [_P, _P, _I64, _I64, _P]),
    "epscc_grid_labels": (None, [_P, _P, _P, _P, _I64, _P]),
    "runs_of_sorted_i64": (_I64, [_P, _I64, _P, _P]),
    "flat_run_positions": (None, [_P, _P, _I64, _P, _P, _P]),
}


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"librhccq_native-{h}.so")


def build() -> str:
    """Compile the runtime if its hashed library is missing; return its path.

    The compiler flags are the JAX package's, so both packages run the same
    machine code on one host.  The library is written to a temporary name and
    renamed, so concurrent test workers never load a half-written file.
    """
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                "building the native runtime failed:\n"
                + proc.stderr.decode(errors="replace")[-2000:]
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


_off = None


def available() -> bool:
    """Whether the runtime is in use: False under RHCCQ_NATIVE=0, read at the
    first call of the process."""
    global _off
    if _off is None:
        _off = os.environ.get("RHCCQ_NATIVE") == "0"
    return not _off


def get_lib():
    """The loaded runtime (built on first use), or None under RHCCQ_NATIVE=0.
    Without the switch a failed build or load raises."""
    global _lib
    if not available():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data


def rle_encode(indices: np.ndarray) -> np.ndarray:
    """(n,) uint16 -> (pairs, 2) uint16 [(value, run)] with runs <= 65535."""
    flat = np.ascontiguousarray(indices, dtype=np.uint16).reshape(-1)
    lib = get_lib()
    if lib is not None:
        out = np.empty((flat.size or 1, 2), np.uint16)
        n_pairs = lib.rle_encode_u16(_ptr(flat), flat.size, _ptr(out))
        return out[:n_pairs].copy()
    # numpy: runs split at value changes and at the 65535 cap.
    if flat.size == 0:
        return np.empty((0, 2), np.uint16)
    change = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate([[0], change])
    runs = np.diff(np.concatenate([starts, [flat.size]]))
    pieces = -(-runs // 65535)
    values = np.repeat(flat[starts], pieces)
    lens = np.full(len(values), 65535, np.int64)
    last = np.cumsum(pieces) - 1
    lens[last] = runs - (pieces - 1) * 65535
    return np.stack([values, lens.astype(np.uint16)], 1)


def rle_decode(pairs: np.ndarray, total: int) -> np.ndarray:
    """(pairs, 2) uint16 -> (total,) uint16."""
    pairs = np.ascontiguousarray(pairs, dtype=np.uint16).reshape(-1, 2)
    lib = get_lib()
    if lib is None:
        return np.repeat(pairs[:, 0], pairs[:, 1])[:total]
    out = np.empty(total, np.uint16)
    n = lib.rle_decode_u16(_ptr(pairs), pairs.shape[0], _ptr(out), total)
    if n < 0:
        raise ValueError("RLE stream longer than declared size")
    return out[:n].copy()


def _check_size(h: int, w: int) -> None:
    if h * w >= 2**31:
        raise ValueError(f"image of {h}x{w} pixels exceeds the runtime's int32 indexing")


def cc_label(mask: np.ndarray, connectivity: int = 8):
    """Union-find CCL: (labels int32 0=bg/1..n, n, stats (n, 5) int64
    [area, minr, minc, maxr_excl, maxc_excl])."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    h, w = m.shape
    _check_size(h, w)
    labels = np.empty((h, w), np.int32)
    stats = np.empty((max(h * w // 2 + 1, 1), 5), np.int64)
    n = lib.cc_label(_ptr(m), h, w, connectivity, _ptr(labels), _ptr(stats))
    return labels, int(n), stats[:n].copy()


def component_stats(labels: np.ndarray, num_labels: int):
    """Per-label (areas int64, bboxes int32 (minr, minc, maxr+1, maxc+1))."""
    lib = get_lib()
    if lib is None:
        return None
    lb = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = lb.shape
    areas = np.empty(num_labels, np.int64)
    bboxes = np.empty((num_labels, 4), np.int32)
    lib.component_stats(_ptr(lb), h, w, int(num_labels), _ptr(areas), _ptr(bboxes))
    return areas, bboxes


def canny_analysis(image_rgb: np.ndarray):
    """(gray u8 (h, w), mag int32 (h, w), nms bool (h, w), cands f32 (20, 2))."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(image_rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    _check_size(h, w)
    gray = np.empty((h, w), np.uint8)
    mag = np.empty((h, w), np.int32)
    nms = np.empty((h, w), np.uint8)
    cands = np.empty((20, 2), np.float32)
    lib.canny_analysis(_ptr(img), h, w, _ptr(gray), _ptr(mag), _ptr(nms), _ptr(cands))
    return gray, mag, nms.astype(bool), cands


def score_candidates(gray, mag, nms, cands) -> int:
    """Index of the best (low, high) Canny candidate."""
    lib = get_lib()
    if lib is None:
        return None
    g = np.ascontiguousarray(gray, dtype=np.uint8)
    m = np.ascontiguousarray(mag, dtype=np.int32)
    nm = np.ascontiguousarray(nms != 0, dtype=np.uint8)
    c = np.ascontiguousarray(cands, dtype=np.float32)
    h, w = g.shape
    _check_size(h, w)
    return int(lib.score_candidates(
        _ptr(g), _ptr(m), _ptr(nm), h, w, _ptr(c), c.shape[0]
    ))


def gradient_nms_rgb(image_rgb: np.ndarray):
    """Color gradient/NMS (cv2.Canny semantics) -> (mag int32, nms bool)."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(image_rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    _check_size(h, w)
    mag = np.empty((h, w), np.int32)
    nms = np.empty((h, w), np.uint8)
    lib.gradient_nms_rgb(_ptr(img), h, w, _ptr(mag), _ptr(nms))
    return mag, nms.astype(bool)


def roi_pipeline(image_rgb: np.ndarray, low: float, high: float, rc):
    """ROI mask pipeline on the host: (roi_mask, nonroi_mask) bool arrays."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(image_rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    _check_size(h, w)
    ip = np.asarray(
        [
            rc.density_kernel, rc.thin_window, rc.thin_min_region_size,
            rc.noise_min_size, rc.noise_window, rc.close_distance,
            rc.bridge1_max_gap, rc.bridge_local_window,
            rc.bridge_regional_window, rc.border_protect_kernel,
            rc.bridge2_max_gap, rc.fill_min_hole, rc.fill_max_hole,
            rc.clean_min_size, rc.buffer_size,
        ],
        np.int32,
    )
    fp = np.asarray(
        [
            low, high, rc.thin_density_threshold, rc.thin_thinness_threshold,
            rc.noise_density_threshold, rc.bridge1_density,
            rc.border_sensitivity,
        ],
        np.float32,
    )
    roi = np.empty((h, w), np.uint8)
    nonroi = np.empty((h, w), np.uint8)
    lib.roi_pipeline(_ptr(img), h, w, _ptr(ip), _ptr(fp), _ptr(roi), _ptr(nonroi))
    return roi.astype(bool), nonroi.astype(bool)


def slic_enforce(assign: np.ndarray, mask: np.ndarray, min_size: int) -> np.ndarray:
    """SLIC connectivity enforcement: (h, w) int32 adopted fragment ids
    (-1 outside mask)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(assign, dtype=np.int32)
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    h, w = a.shape
    _check_size(h, w)
    out = np.empty((h, w), np.int32)
    lib.slic_enforce(_ptr(a), _ptr(m), h, w, int(min_size), _ptr(out))
    return out


def pack_pairs(image_rgb: np.ndarray, seg_map: np.ndarray):
    """Tier-1 (segment, color) pair table: (uniq_keys int64 (m,), inverse
    int64 (n_masked,), counts int64 (m,)), inverse over seg>0 pixels in
    row-major order."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(image_rgb, dtype=np.uint8).reshape(-1, 3)
    seg = np.ascontiguousarray(seg_map, dtype=np.int32).reshape(-1)
    n_masked = int(np.count_nonzero(seg > 0))
    if n_masked == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    uniq = np.empty(n_masked, np.int64)
    inverse = np.empty(n_masked, np.int64)
    counts = np.empty(n_masked, np.int64)
    m = lib.pack_pairs(
        _ptr(rgb), _ptr(seg), seg.size, _ptr(uniq), _ptr(inverse), _ptr(counts)
    )
    return uniq[:m].copy(), inverse, counts[:m].copy()


def black_repair_pairs(uniq: np.ndarray, counts: np.ndarray,
                       inverse: np.ndarray | None, return_remap: bool = False):
    """Per-segment black repair of a sorted pair table, in place.

    uniq/counts: (m,) int64 sorted seg<<24|rgb keys and pixel counts; inverse:
    (n_masked,) int64 pair ids, or None to repair the table only (the device
    pair table keeps the per-pixel state on the device and applies the remap
    there).  Black pairs in segments with non-black colours remap to the
    segment's darkest non-black pair (counts fold into the target); the table
    compacts in place and inverse, when given, is rewritten.  Returns the
    compacted pair count, or (count, remap (m,) int64 old row -> new row) with
    return_remap.
    """
    lib = get_lib()
    if lib is None:
        return None
    for a in (uniq, counts) + (() if inverse is None else (inverse,)):
        if a.dtype != np.int64 or not a.flags.c_contiguous:
            raise ValueError("black_repair_pairs takes contiguous int64 arrays")
    remap = np.empty(len(uniq), np.int64)
    m = int(lib.black_repair_pairs(
        _ptr(uniq), _ptr(counts), len(uniq),
        None if inverse is None else _ptr(inverse),
        0 if inverse is None else inverse.size, _ptr(remap),
    ))
    return (m, remap) if return_remap else m


def unpack_pair_table(table: np.ndarray):
    """(uniq int64, counts int64), the pack_pairs key layout, from a device
    pair table: (n, 3) int32 rows [seg, col, count]."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(table)
    if t.ndim != 2 or t.shape[1] != 3 or t.dtype != np.int32:
        raise ValueError("unpack_pair_table takes an (n, 3) int32 table")
    n = len(t)
    uniq = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    lib.unpack_pair_table_i32(_ptr(t), n, _ptr(uniq), _ptr(counts))
    return uniq, counts


def split_pair_uniq(uniq: np.ndarray):
    """(seg int32, col int32, colors float32 (m, 3)) from sorted pair keys."""
    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(uniq, dtype=np.int64)
    m = len(u)
    seg = np.empty(m, np.int32)
    col = np.empty(m, np.int32)
    colors = np.empty((m, 3), np.float32)
    lib.split_pair_uniq(_ptr(u), m, _ptr(seg), _ptr(col), _ptr(colors))
    return seg, col, colors


def cluster_means_u8(cluster_of_pair, colors_packed, weights, n_clusters: int):
    """Weighted per-cluster mean colors truncated to uint8: (n_clusters, 3)."""
    lib = get_lib()
    if lib is None:
        return None
    cl = np.ascontiguousarray(cluster_of_pair, dtype=np.int64)
    co = np.ascontiguousarray(colors_packed, dtype=np.int32)
    w = None if weights is None else np.ascontiguousarray(weights, dtype=np.float64)
    out = np.empty((n_clusters, 3), np.uint8)
    lib.cluster_means_u8(
        _ptr(cl), _ptr(co), None if w is None else _ptr(w), cl.size,
        int(n_clusters), _ptr(out),
    )
    return out


def paint_masked_indices(idx_of_pair, inverse, mask, out: np.ndarray) -> bool:
    """out[mask] = idx_of_pair[inverse] in row-major mask order, in place,
    into a 1/2/4-byte unsigned index canvas; False without the runtime."""
    lib = get_lib()
    if lib is None:
        return False
    idx = np.ascontiguousarray(idx_of_pair, dtype=np.int32)
    inv = np.ascontiguousarray(inverse, dtype=np.int64)
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8).reshape(-1)
    if not out.flags.c_contiguous or out.size != m.size or out.dtype.itemsize not in (1, 2, 4):
        raise ValueError("paint_masked_indices needs a contiguous u8/u16/u32 canvas of the mask's size")
    lib.paint_masked_indices(
        _ptr(idx), _ptr(inv), _ptr(m), m.size, out.dtype.itemsize, _ptr(out)
    )
    return True


def paint_masked_colors(table: np.ndarray, idx1, inverse: np.ndarray,
                        mask: np.ndarray, out: np.ndarray) -> bool:
    """out[mask] = table[idx1[inverse]] (or table[inverse] when idx1 is None)
    in row-major mask order, in place, into an (..., 3) uint8 canvas; False
    without the runtime."""
    lib = get_lib()
    if lib is None:
        return False
    t = np.ascontiguousarray(table, dtype=np.uint8)
    inv = np.ascontiguousarray(inverse, dtype=np.int64)
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8).reshape(-1)
    if out.dtype != np.uint8 or not out.flags.c_contiguous or out.size != m.size * 3:
        raise ValueError("paint_masked_colors needs a contiguous uint8 (..., 3) canvas of the mask's size")
    i1 = None if idx1 is None else np.ascontiguousarray(idx1, dtype=np.int64)
    lib.paint_masked_colors(
        _ptr(t), None if i1 is None else _ptr(i1), _ptr(inv), _ptr(m), m.size, _ptr(out)
    )
    return True


def pack_sel_keys(colors: np.ndarray, sel: np.ndarray, tag: int,
                  out: np.ndarray, offset: int) -> int:
    """Write tag << 24 | rgb keys of the sel pixels into out[offset:], in
    row-major order; returns the number written."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(colors, dtype=np.uint8).reshape(-1, 3)
    s = np.ascontiguousarray(sel, dtype=np.uint8).reshape(-1)
    if out.dtype != np.int64 or not out.flags.c_contiguous or out.size - offset < int(s.sum()):
        raise ValueError("pack_sel_keys needs a contiguous int64 buffer with room for every sel pixel")
    return int(lib.pack_sel(_ptr(c), _ptr(s), s.size, int(tag), _ptr(out) + offset * 8))


def epscc_labels_runs(colors_packed, starts, sizes, eps) -> np.ndarray:
    """Exact eps-CC labels for many palette runs via grid union-find.

    Run r is colors_packed[starts[r] : starts[r]+sizes[r]] (0xRRGGBB int32);
    eps[r] its radius, squared in float32 like the device predicate.  Returns
    run-major int32 labels: the run-local minimum member index per component.
    """
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    eps2 = np.ascontiguousarray(eps, np.float32) ** 2
    colors_packed = np.ascontiguousarray(colors_packed, np.int32)
    labels = np.empty(int(sizes.sum()), np.int32)
    lib.epscc_grid_labels(
        _ptr(colors_packed), _ptr(starts), _ptr(sizes), _ptr(eps2), len(starts),
        _ptr(labels),
    )
    return labels


def argsort_i64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of int64 keys (radix sort; numpy's without the runtime)."""
    flat = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
    lib = get_lib()
    if lib is None:
        return np.argsort(flat, kind="stable")
    if flat.size == 0:
        return np.zeros(0, np.int64)
    order = np.empty(flat.size, np.int64)
    lib.argsort_i64(_ptr(flat), flat.size, _ptr(order))
    return order


def unique_inverse_i64(keys: np.ndarray, return_counts: bool = False):
    """np.unique(keys, return_inverse=True[, return_counts]) for int64 keys
    (np.unique itself without the runtime)."""
    flat = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
    lib = get_lib()
    if lib is None:
        out = np.unique(flat, return_inverse=True, return_counts=return_counts)
        return out if return_counts else (out[0], out[1])
    if flat.size == 0:
        z = np.zeros(0, np.int64)
        return (z, z.copy(), z.copy()) if return_counts else (z, z.copy())
    uniq = np.empty(flat.size, np.int64)
    inverse = np.empty(flat.size, np.int64)
    counts = np.empty(flat.size, np.int64) if return_counts else None
    m = lib.sort_unique_inverse(
        _ptr(flat), flat.size, _ptr(uniq), _ptr(inverse),
        _ptr(counts) if return_counts else None,
    )
    if return_counts:
        return uniq[:m].copy(), inverse, counts[:m].copy()
    return uniq[:m].copy(), inverse


def runs_of_sorted_i64(sorted_arr: np.ndarray):
    """(values, starts, sizes) of equal runs in an already-sorted int64 array."""
    flat = np.ascontiguousarray(sorted_arr, dtype=np.int64).reshape(-1)
    if flat.size == 0:
        return flat, np.zeros(0, np.int64), np.zeros(0, np.int64)
    lib = get_lib()
    if lib is None:
        starts = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1])
        sizes = np.diff(np.concatenate([starts, [flat.size]]))
        return flat[starts], starts, sizes
    starts = np.empty(flat.size, np.int64)
    sizes = np.empty(flat.size, np.int64)
    m = lib.runs_of_sorted_i64(_ptr(flat), flat.size, _ptr(starts), _ptr(sizes))
    starts = starts[:m].copy()
    return flat[starts], starts, sizes[:m].copy()


def flat_run_positions(starts: np.ndarray, sizes: np.ndarray):
    """(pos, row, within) enumerating every element of m runs."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    lib = get_lib()
    if lib is None or total == 0:
        off = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1], out=off[1:])
        row = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
        within = np.arange(total, dtype=np.int64) - np.repeat(off, sizes)
        return np.repeat(starts, sizes) + within, row, within
    pos = np.empty(total, np.int64)
    row = np.empty(total, np.int64)
    within = np.empty(total, np.int64)
    lib.flat_run_positions(
        _ptr(starts), _ptr(sizes), len(sizes), _ptr(pos), _ptr(row), _ptr(within)
    )
    return pos, row, within


# ---------------------------------------------------------------------------
# libdeflate-backed zlib streams (system library).  libdeflate writes standard
# RFC 1950 zlib streams, byte-different from zlib's own output but readable by
# any inflater.  Python's zlib is the fallback when the library is absent.
# ---------------------------------------------------------------------------

_ld_lock = threading.Lock()
_ld = None
_ld_name = None
_ld_tried = False


def libdeflate():
    """(ctypes library or None, the name it was loaded by or None)."""
    global _ld, _ld_name, _ld_tried
    with _ld_lock:
        if _ld_tried:
            return _ld, _ld_name
        _ld_tried = True
        for name in ("libdeflate.so.0", "libdeflate.so", "libdeflate.so.1"):
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.libdeflate_alloc_compressor.restype = _P
            lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
            lib.libdeflate_free_compressor.argtypes = [_P]
            lib.libdeflate_zlib_compress_bound.restype = ctypes.c_size_t
            lib.libdeflate_zlib_compress_bound.argtypes = [_P, ctypes.c_size_t]
            lib.libdeflate_zlib_compress.restype = ctypes.c_size_t
            lib.libdeflate_zlib_compress.argtypes = [
                _P, _P, ctypes.c_size_t, _P, ctypes.c_size_t,
            ]
            lib.libdeflate_alloc_decompressor.restype = _P
            lib.libdeflate_free_decompressor.argtypes = [_P]
            lib.libdeflate_zlib_decompress.restype = ctypes.c_int
            lib.libdeflate_zlib_decompress.argtypes = [
                _P, _P, ctypes.c_size_t, _P, ctypes.c_size_t, _P,
            ]
            _ld, _ld_name = lib, name
            break
        return _ld, _ld_name


def zlib_compress_fast(data, level: int = 12) -> bytes:
    """zlib-format compression via libdeflate (levels 1-12); zlib level
    min(level, 9) when libdeflate is absent."""
    import zlib as _z

    lib, _ = libdeflate()
    buf = bytes(data)
    if lib is None:
        return _z.compress(buf, min(int(level), 9))
    n = len(buf)
    comp = lib.libdeflate_alloc_compressor(int(level))
    if not comp:
        return _z.compress(buf, min(int(level), 9))
    try:
        bound = lib.libdeflate_zlib_compress_bound(comp, n)
        out = ctypes.create_string_buffer(bound)
        src = (ctypes.c_char * n).from_buffer_copy(buf) if n else None
        m = lib.libdeflate_zlib_compress(comp, src, n, out, bound)
        if m == 0:
            return _z.compress(buf, min(int(level), 9))
        return out.raw[:m]
    finally:
        lib.libdeflate_free_compressor(comp)


def zlib_decompress_fast(data: bytes, out_size: int | None = None) -> bytes:
    """zlib-format decompression via libdeflate; zlib when it is absent."""
    import zlib as _z

    lib, _ = libdeflate()
    if lib is None:
        return _z.decompress(data)
    n = len(data)
    dec = lib.libdeflate_alloc_decompressor()
    if not dec:
        return _z.decompress(data)
    try:
        src = (ctypes.c_char * n).from_buffer_copy(data) if n else None
        cap = int(out_size) if out_size else max(4 * n, 1 << 16)
        actual = ctypes.c_size_t(0)
        for _ in range(8):
            out = ctypes.create_string_buffer(cap)
            rc = lib.libdeflate_zlib_decompress(dec, src, n, out, cap, ctypes.byref(actual))
            if rc == 0:
                if out_size is not None and actual.value != out_size:
                    raise ValueError(
                        f"zlib stream decoded to {actual.value} bytes, expected {out_size}"
                    )
                return out.raw[: actual.value]
            if rc == 3 and out_size is None:  # INSUFFICIENT_SPACE: grow
                cap *= 4
                continue
            raise ValueError(f"bad zlib stream (libdeflate rc={rc})")
        return _z.decompress(data)
    finally:
        lib.libdeflate_free_decompressor(dec)
