"""The .rhccq container: palette + index matrix with zlib entropy coding.

    file := b"RHCCQ" | <u32 little-endian payload length> | zlib(pickle(dict))
    dict := {'s': (h, w), 'l': n_colors, 'p': zlib(palette u8 bytes),
             'i': zlib(indices minimal-dtype bytes), 'd': dtype name}

The same writer and reader as the JAX package's `io/container.py`: equal
inputs give equal bytes at every level.  An older layout uses key 'ps'
instead of 'l' and omits 'd'.  Reading uses a restricted unpickler that
resolves only a few numpy data constructors, so a hostile file cannot run
code.  This module is host code: DEFLATE stays on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as _io
import pickle
import struct
import zlib

import numpy as np

from roibasedimagecompression_torch import native

MAGIC = b"RHCCQ"

_DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32}

# Data-only constructors that reference writers may pickle (numpy scalars in
# the shape tuple); they are the whole allowlist.
_SAFE_GLOBALS = {
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickler that only resolves a tiny numpy data-constructor allowlist."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            import importlib

            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"rhccq container may not reference globals ({module}.{name})"
        )


def _restricted_loads(data: bytes):
    return _RestrictedUnpickler(_io.BytesIO(data)).load()


def min_index_dtype(max_index: int) -> np.dtype:
    """Smallest unsigned dtype for palette indices."""
    if max_index < 256:
        return np.dtype(np.uint8)
    if max_index < 65536:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32)


@dataclasses.dataclass
class Rhccq:
    """Decoded container payload: a palette image in indexed form."""

    palette: np.ndarray  # (n, 3) uint8
    indices: np.ndarray  # (h, w) unsigned int
    shape: tuple  # (h, w)

    @property
    def n_colors(self) -> int:
        return int(self.palette.shape[0])

    def to_rgb(self) -> np.ndarray:
        """Palette gather -> (h, w, 3) uint8."""
        return self.palette[self.indices]


def _compress(data: bytes, level: int) -> bytes:
    """Level 0 = zlib level 9 (the reference writer's bytes); 1-12 =
    libdeflate at that level (a standard zlib stream)."""
    if level == 0:
        return zlib.compress(data, 9)
    return native.zlib_compress_fast(data, level)


def pack(
    palette: np.ndarray,
    indices: np.ndarray,
    shape=None,
    *,
    use_rle: bool = False,
    level: int = 0,
) -> bytes:
    """Serialize palette + indices to .rhccq bytes.

    Pickle protocol 5, minimal index dtype from the max index; the outer
    pickled dict is compressed at zlib 9 for level 0 and libdeflate 1 else.
    use_rle stores (value, run) u16 pairs under the extra key 'm'.
    """
    palette = np.ascontiguousarray(np.asarray(palette, dtype=np.uint8).reshape(-1, 3))
    indices = np.asarray(indices)
    if shape is None:
        if indices.ndim != 2:
            raise ValueError("shape required when indices are flat")
        shape = indices.shape
    h, w = int(shape[0]), int(shape[1])
    flat = indices.reshape(-1)
    max_index = int(flat.max()) if flat.size else 0
    if max_index >= palette.shape[0]:
        raise ValueError(f"index {max_index} out of range for palette of {palette.shape[0]}")
    dtype = min_index_dtype(max_index)
    if use_rle and max_index >= 65536:
        raise ValueError(
            f"RLE mode stores u16 indices; palette has {max_index + 1} colors"
        )
    if use_rle:
        pairs = native.rle_encode(flat.astype(np.uint16))
        payload = {
            "s": (h, w),
            "l": int(palette.shape[0]),
            "p": _compress(palette.tobytes(), level),
            "i": _compress(np.ascontiguousarray(pairs).tobytes(), level),
            "d": "uint16",
            "m": "rle",
        }
    else:
        payload = {
            "s": (h, w),
            "l": int(palette.shape[0]),
            "p": _compress(palette.tobytes(), level),
            "i": _compress(np.ascontiguousarray(flat.astype(dtype)).tobytes(), level),
            "d": dtype.name,
        }
    blob = _compress(pickle.dumps(payload, protocol=5), 0 if level == 0 else 1)
    return MAGIC + struct.pack("<I", len(blob)) + blob


def unpack(data: bytes) -> Rhccq:
    """Parse .rhccq bytes (both the 'l'/'d' and legacy 'ps' layouts)."""
    if data[:5] != MAGIC:
        raise ValueError("Invalid file format")
    (size,) = struct.unpack("<I", data[5:9])
    payload = _restricted_loads(native.zlib_decompress_fast(data[9 : 9 + size]))
    if not isinstance(payload, dict):
        raise ValueError("corrupt container payload")
    h, w = payload["s"]
    if "l" not in payload and "ps" not in payload:
        raise ValueError("corrupt container payload (no palette length)")
    n_colors = int(payload.get("l", payload.get("ps")))
    palette = np.frombuffer(
        native.zlib_decompress_fast(payload["p"], n_colors * 3), dtype=np.uint8
    )
    palette = palette.reshape(n_colors, 3).copy()
    raw = native.zlib_decompress_fast(payload["i"])
    if payload.get("m") == "rle":
        pairs = np.frombuffer(raw, dtype=np.uint16).reshape(-1, 2)
        indices = native.rle_decode(pairs, h * w).reshape(h, w)
        return Rhccq(palette=palette, indices=indices, shape=(int(h), int(w)))
    dtype_name = payload.get("d")
    if dtype_name in _DTYPES:
        dtype = _DTYPES[dtype_name]
    else:
        # Legacy layout: size-based inference.
        total = h * w
        bpp = len(raw) / total if total else 2
        dtype = np.uint8 if bpp <= 1 else (np.uint16 if bpp <= 2 else np.uint32)
    indices = np.frombuffer(raw, dtype=dtype).reshape(h, w).copy()
    return Rhccq(palette=palette, indices=indices, shape=(int(h), int(w)))


def payload_digest(data: bytes) -> str:
    """sha256 of a container's payload: the unpacked palette's bytes, then
    the index matrix's bytes and its shape.  Equal payloads give equal
    digests whatever DEFLATE (zlib or libdeflate, any level) wrote them."""
    p = unpack(data)
    h = hashlib.sha256()
    h.update(p.palette.tobytes())
    h.update(p.indices.tobytes())
    h.update(repr(tuple(int(s) for s in p.indices.shape)).encode())
    return h.hexdigest()


def save(palette: np.ndarray, indices: np.ndarray, path, shape=None, *,
         use_rle: bool = False) -> int:
    """Write an .rhccq file (level 0); returns the file size in bytes."""
    data = pack(palette, indices, shape, use_rle=use_rle)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load(path) -> Rhccq:
    with open(path, "rb") as f:
        return unpack(f.read())


def describe(data: bytes) -> str:
    """Human-readable report of a container: shape, palette, index dtype
    against the smallest that holds the indices, and the rate."""
    payload = unpack(data)
    h, w = payload.shape
    n = payload.n_colors
    dtype = payload.indices.dtype
    optimal = min_index_dtype(int(payload.indices.max()) if payload.indices.size else 0)
    raw = h * w * 3
    lines = [
        f"shape: {w}x{h} ({h * w:,} pixels)",
        f"palette: {n} colors ({n * 3:,} bytes raw)",
        f"indices: dtype {dtype.name} ({payload.indices.nbytes:,} bytes raw); "
        f"optimal dtype {optimal.name}"
        + ("" if dtype == optimal else "  <- downgradable"),
        f"file: {len(data):,} bytes = {len(data) * 8 / (h * w):.3f} bpp, "
        f"{raw / len(data):.2f}:1 vs raw RGB",
    ]
    return "\n".join(lines)


def decode_file(path) -> np.ndarray:
    """Load + reconstruct: .rhccq path -> (h, w, 3) uint8 RGB."""
    return load(path).to_rgb()
