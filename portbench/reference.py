"""The plain reference that decides `correct`: NumPy, zlib and hashlib only.

It imports nothing of the program, of the JAX package or of JAX, and takes
nothing the program made but the container bytes it judges.  For each
answer (one `.rhccq` container for one image) it works out:

- the container's payload, with a reader of its own (`MAGIC`, a u32 length,
  zlib of a pickled dict holding the shape, the palette and the index
  matrix, each zlib-compressed), and whether the shape is the image's and
  every index lies inside the palette;
- the refit law of the codec's last stage: every palette entry that pixels
  use and that is not black is the float64 mean of those pixels of the
  ORIGINAL image, rounded half to even (black entries are the background
  sentinel and are kept as they are);
- the payload digest (sha256 of the palette's bytes, the index matrix's
  bytes in its stored dtype, and repr of its shape), held against the
  digest that the JAX package wrote for the same image and configuration
  (`configs/<config>.digests.json`, data written on the CPU with the JAX
  package, which no run loads).
  The codec's bytes are fixed by the JAX package's arithmetic to the last
  bit, so its recorded answer is the reference for every layer upstream of
  the refit: frontend, segment, tier 1 and tiers 2/3.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import struct
import zlib

import numpy as np

MAGIC = b"RHCCQ"
_DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32}
# Data constructors a writer may pickle inside the payload (numpy scalars);
# nothing else resolves, so a hostile payload cannot run code.
_SAFE = {("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
         ("numpy", "dtype")}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE:
            import importlib

            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(f"global {module}.{name} in a container")


def parse(data: bytes):
    """(palette (n, 3) uint8, indices (h, w), shape (h, w)) of a container;
    raises ValueError on anything malformed."""
    if not isinstance(data, (bytes, bytearray)) or data[:5] != MAGIC:
        raise ValueError("not an rhccq container")
    (size,) = struct.unpack("<I", data[5:9])
    try:
        payload = _Unpickler(io.BytesIO(zlib.decompress(data[9:9 + size]))).load()
        h, w = (int(v) for v in payload["s"])
        n = int(payload["l"])
        palette = np.frombuffer(zlib.decompress(payload["p"]), np.uint8).reshape(n, 3)
        if payload.get("m") is not None:
            raise ValueError("run-length index streams are not a path this benchmark drives")
        indices = np.frombuffer(zlib.decompress(payload["i"]), _DTYPES[payload["d"]]).reshape(h, w)
    except (KeyError, TypeError, zlib.error, pickle.UnpicklingError, EOFError) as exc:
        raise ValueError(f"corrupt container: {exc!r}") from exc
    return palette, indices, (h, w)


def digest(palette: np.ndarray, indices: np.ndarray) -> str:
    """sha256 of the palette's bytes, the index matrix's bytes and its shape."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(palette).tobytes())
    h.update(np.ascontiguousarray(indices).tobytes())
    h.update(repr(tuple(int(s) for s in indices.shape)).encode())
    return h.hexdigest()


def refit_gap(image: np.ndarray, palette: np.ndarray, indices: np.ndarray) -> int:
    """Largest distance, in levels of one channel, between a used non-black
    palette entry and the rounded mean of the original pixels it paints."""
    idx = indices.reshape(-1).astype(np.int64)
    flat = image.reshape(-1, 3).astype(np.float64)
    k = len(palette)
    counts = np.bincount(idx, minlength=k)
    checked = (counts > 0) & ~(palette == 0).all(axis=1)
    if not checked.any():
        return 0
    sums = np.stack([np.bincount(idx, weights=flat[:, c], minlength=k) for c in range(3)], 1)
    means = np.round(sums[checked] / counts[checked, None])
    return int(np.abs(means - palette[checked].astype(np.float64)).max())


def judge(image: np.ndarray, data, expected_digest: str | None) -> dict:
    """Reference readings of one answer: `malformed` (0 or 1: no container,
    an unreadable one, a wrong shape or an index outside the palette),
    `refit_gap` (levels; None when malformed), `digest_differs` (0 or 1; 1
    where no digest was recorded for this image)."""
    try:
        palette, indices, shape = parse(data)
    except ValueError:
        return {"malformed": 1, "refit_gap": None, "digest_differs": 1}
    if shape != tuple(image.shape[:2]) or (indices.size and int(indices.max()) >= len(palette)):
        return {"malformed": 1, "refit_gap": None, "digest_differs": 1}
    differs = int(expected_digest is None or digest(palette, indices) != expected_digest)
    return {"malformed": 0, "refit_gap": refit_gap(image, palette, indices),
            "digest_differs": differs}
