"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
`sm_90a` into a shared library in the package's `_build/` directory, named
by its build key (`utils/cachekey.py`: the source, the flags and nvcc's
release line), then loaded with ctypes.  Nothing is built when a module is
imported: the first launch builds, or `build_all()` builds every kernel at
once with one nvcc process per source, started together (`prebuild()` does
so under the loader's lock, as `utils/warmup.py prewarm` calls it).

Every launch goes through `launch`, which loads the library, launches on the
device's current stream and records the launch in `launched`: for each
kernel source a `Counter` from the wrapper's shape key of a launch to the
count of such launches since the last `reset_launches`.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from roibasedimagecompression_torch.utils import cachekey

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("slic_assign", "epscc", "gumbel", "kmeanspp")

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel source -> {launch function: its argument types}; every launch
# function returns a cudaError_t as an int.
_LAUNCHERS = {
    "slic_assign": {"slic_assign_launch": [_P, _P, _P, _I, _I, _I, _P],
                    "slic_assign_expanded_launch": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "epscc": {
        "eps_pack_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
        "eps_sweep_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "eps_components_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "gumbel": {"gumbel_launch": [_P, _P, _I, _I, _P]},
    "kmeanspp": {"kmeanspp_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}

# kernel source -> Counter(shape key -> launches); cleared in place, so a
# reader may keep a reference to one Counter.
launched = {name: collections.Counter() for name in KERNELS}
_launched_lock = threading.Lock()  # encode_stream launches from several threads


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_key(name: str, release: str) -> str:
    """The build key of kernel `name` for an nvcc of `release`."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        return cachekey.build_key(f.read(), NVCC_FLAGS, release)


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{lib_key(name, cachekey.nvcc_release())}.so")


def build_all(names=KERNELS) -> dict:
    """Compile every missing kernel library in parallel; {name: seconds}.

    Raises RuntimeError with the compiler's output if any build fails.
    """
    import time

    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return {n: 0.0 for n in names}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, os.path.join(CSRC, f"{name}.cu"), "-o", tmp]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        ))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out.decode(errors="replace")
        if proc.returncode == 0:
            os.replace(tmp, lib_path(name))
        else:
            failed.append(name)
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(build_log[n][-3000:] for n in failed)
        )
    return {n: seconds.get(n, 0.0) for n in names}


def prebuild() -> dict:
    """`build_all()` under the loader's lock: a launch that needs a kernel
    meanwhile waits for this build instead of starting its own."""
    with _lock:
        return build_all()


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [_I]
            for fn_name, argtypes in _LAUNCHERS[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = _I
                fn.argtypes = argtypes
            _libs[name] = lib
        return lib


def launch(name: str, fn_name: str, device: torch.device, *args, key=None) -> None:
    """Call the launch function `fn_name(*args, stream)` of kernel source
    `name` with `device`'s current stream, on that device, and raise if it
    returns a CUDA error.  A launch given a shape `key` is recorded under it
    in `launched[name]`; one without (a helper launch that precedes a counted
    one) is not."""
    lib = load(name)
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        rc = getattr(lib, fn_name)(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {lib.kernel_error_string(rc).decode()}")
    if key is not None:
        with _launched_lock:
            launched[name][key] += 1


def reset_launches() -> None:
    """Clear every kernel's launch record in place."""
    with _launched_lock:
        for counter in launched.values():
            counter.clear()
