"""Stable build keys for the libraries in the package's `_build/` directory.

The counterpart of the JAX package's `utils/cachekey.py`, which keys XLA's
persistent compile cache by the backend's compatibility identity and not its
volatile build stamp.  The port compiles no graphs; what it builds is its two
CUDA kernel libraries (`ops/cuda/_build.py`) and the native host runtime.  A
kernel library is named by a key over its source, the nvcc flags and the
compiler's release line (`nvcc --version`'s "release X.Y"): a new release
re-keys every library, a rebuild of the same release does not, and neither
the "Built on" stamp nor any path enters the key.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import subprocess

_BUILD_LINE = re.compile(r"^Built on .*$", re.MULTILINE)
_RELEASE = re.compile(r"release (\d+\.\d+)")


def stable_compiler_string(version_text: str) -> str:
    """`nvcc --version` output with the volatile "Built on" lines removed."""
    return _BUILD_LINE.sub("", version_text).strip()


def release_line(version_text: str) -> str:
    """The compiler's "release X.Y" from its version text; raises when it has
    none."""
    m = _RELEASE.search(stable_compiler_string(version_text))
    if m is None:
        raise ValueError("no 'release X.Y' in the compiler's version text")
    return f"release {m.group(1)}"


def build_key(source: bytes, flags, release: str) -> str:
    """The 12-hex-digit key that names a built library: its source, its
    compiler flags, and the compiler's release line."""
    h = hashlib.sha256(source)
    h.update(" ".join(flags).encode())
    h.update(release.encode())
    return h.hexdigest()[:12]


@functools.lru_cache(maxsize=1)
def nvcc_release() -> str:
    """The release line of the nvcc that builds the kernels (raises without
    nvcc)."""
    from roibasedimagecompression_torch.ops.cuda import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60)
    return release_line(out.stdout)


def identity_report() -> dict:
    """What the built libraries depend on: torch and its CUDA, the nvcc
    release, the card's name and compute capability, and the key of every
    kernel library (None for what cannot be known here, such as the card or
    nvcc on a machine without them)."""
    import torch

    from roibasedimagecompression_torch import native
    from roibasedimagecompression_torch.ops.cuda import _build

    try:
        release = nvcc_release()
    except (RuntimeError, OSError, subprocess.SubprocessError, ValueError):
        release = None
    card = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc_release": release,
        "device_name": torch.cuda.get_device_name(0) if card else None,
        "capability": ".".join(map(str, torch.cuda.get_device_capability(0))) if card else None,
        "build_keys": {name: (_build.lib_key(name, release) if release else None)
                       for name in _build.KERNELS},
        "native_lib": os.path.basename(native.lib_path()),
    }
