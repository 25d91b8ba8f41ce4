"""PyTorch port, base layer: package hygiene, the vendored runtime, config,
container, PIL-free resize and the threefry PRNG, each held against the JAX
package on the same inputs."""

import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.io import container as jcontainer
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.io import container as tcontainer
from roibasedimagecompression_torch.ops import prng

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "roibasedimagecompression_torch"


def _prebuild_jax_native() -> None:
    """Make sure the JAX package's host runtime is built whole, and let this
    test worker load it (every worker imports this file before any test runs).

    That package compiles its library at first use straight to the final
    path, and two of its test files ask for it while they are collected.  In
    a fresh checkout, with several test workers, one worker can load the file
    while another is still writing it; the package then remembers the failure
    and runs every later test of that worker on its slower fallbacks, which
    write other bytes, and the tests that hold the port against it fail by
    chance.  Here, under a file lock, a library that does not load is rebuilt
    to a private name and renamed into place, and a worker whose package
    gave up is told to try again.  Without a compiler nothing changes."""
    import ctypes
    import fcntl

    from roibasedimagecompression_tpu import native as jnative

    src, path = jnative._SRC, jnative._LIB_PATH
    lock_dir = PORT / "_build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            whole = os.path.getmtime(path) >= os.path.getmtime(src)
            if whole:
                ctypes.CDLL(path)
        except OSError:
            whole = False
        if not whole:
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=600)
            except (OSError, subprocess.SubprocessError):
                return
            os.replace(tmp, path)
    if jnative._lib is None:
        jnative._tried = False


_prebuild_jax_native()


def test_port_imports_no_jax():
    """The port imports every module it has and runs its public functions
    without importing jax or the JAX package (fresh interpreter)."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    assert "roibasedimagecompression_torch.parallel.stream" in modules
    assert "roibasedimagecompression_torch.ops.pairs" in modules
    assert {"roibasedimagecompression_torch.__main__", "roibasedimagecompression_torch.eval.report",
            "roibasedimagecompression_torch.models.enhance", "roibasedimagecompression_torch.models.roi",
            "roibasedimagecompression_torch.models.quantize", "roibasedimagecompression_torch.ops.morphology",
            "roibasedimagecompression_torch.ops.distance", "roibasedimagecompression_torch.ops.cc",
            "roibasedimagecompression_torch.ops.canny", "roibasedimagecompression_torch.ops.unique",
            "roibasedimagecompression_torch.models.roi_fused"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import roibasedimagecompression_torch as rtt\n"
        "from roibasedimagecompression_torch.parallel import stream\n"
        "from roibasedimagecompression_torch.ops import metrics\n"
        "from roibasedimagecompression_torch.utils.synthetic import synthetic_image\n"
        "img = synthetic_image(5, 96, 128)\n"
        "data = rtt.encode(img, device='cpu')\n"
        "out = rtt.decode(data)\n"
        "assert out.shape == img.shape\n"
        "assert rtt.unpack(data).shape == (96, 128)\n"
        "fast = rtt.CodecConfig.low_latency()\n"
        "assert stream.encode_many([img], fast, device='cpu') == [rtt.encode(img, fast, device='cpu')]\n"
        "assert stream.encode_stream([[img], [img]], device='cpu') == [[data], [data]]\n"
        "loop = rtt.encode(img, rtt.CodecConfig(batched=False), device='cpu')\n"
        "assert rtt.decode(loop).shape == img.shape\n"
        "assert metrics.quality_metrics(img, out, device='cpu')['psnr'] > 28\n"
        "from roibasedimagecompression_torch import native\n"
        "from roibasedimagecompression_torch.models import codec\n"
        "native._off = True\n"
        "assert not native.available()\n"
        "assert rtt.decode(rtt.encode(img, rtt.CodecConfig(region_fusion=True, weighted_split=True),"
        " device='cpu')).shape == img.shape\n"
        "assert codec.encode_debug(img, device='cpu')['tier3'].shape == img.shape\n"
        "native._off = False\n"
        "import tempfile, os\n"
        "from roibasedimagecompression_torch import __main__ as cli\n"
        "from roibasedimagecompression_torch.io import image_io\n"
        "from roibasedimagecompression_torch.eval import adaptive, report\n"
        "d = tempfile.mkdtemp()\n"
        "image_io.imwrite(os.path.join(d, 'a.png'), img)\n"
        "assert cli.main(['encode', os.path.join(d, 'a.png'), os.path.join(d, 'a.rhccq'),"
        " '--enhance-shadows', '--split-method', 'kmeans-mc', '--device', 'cpu']) is None\n"
        "assert cli.main(['eval', os.path.join(d, 'a.png'), os.path.join(d, 'a.rhccq'), '--device', 'cpu']) is None\n"
        "assert adaptive.adaptive_quality_metrics(img, out, device='cpu')['all_pixels']['psnr'] > 28\n"
        "assert report.difference_maps(img, out)['absolute'].shape == img.shape\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('roibasedimagecompression_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    # One torch thread: with the tier-1 command's six workers on eight cores,
    # a default pool of one thread per core took 270-290 s of the 300 s.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_port_and_chip_smoke_import_statements():
    """No import statement of the port, or of chip_smoke.py, names jax or the
    JAX package (chip_smoke.py names that package's files in strings only)."""
    import ast

    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    hits = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            hits += [
                (str(path.relative_to(ROOT)), n) for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "roibasedimagecompression_tpu")
            ]
    assert hits == []


def test_port_sources_never_name_the_jax_package():
    hits = [
        str(p.relative_to(ROOT))
        for p in PORT.rglob("*")
        if p.is_file() and p.suffix in (".py", ".cu", ".cpp", ".cuh", ".h")
        and "roibasedimagecompression_tpu" in p.read_text(errors="replace")
    ]
    assert hits == []


def test_cuda_entry_point_raises_without_a_card():
    import torch

    import roibasedimagecompression_torch as rtt

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.encode(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.encode(np.zeros((64, 64, 3), np.uint8), rtt.CodecConfig(batched=False))


def test_native_source_is_byte_identical():
    a = (ROOT / "roibasedimagecompression_tpu/native/rhccq_native.cpp").read_bytes()
    b = (PORT / "native/rhccq_native.cpp").read_bytes()
    assert hashlib.sha256(a).hexdigest() == hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize(
    "overrides",
    [{}, {"roi_quality": 35.0, "nonroi_quality": 15.0, "split_margin": 2.0},
     {"roi": jcfg.RoiConfig(buffer_size=5), "container_level": 7}],
)
def test_config_from_dict_carries_the_laws(overrides):
    jc = jcfg.CodecConfig(**overrides)
    tc = tcfg.from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.roi_tier2_quality, tc.nonroi_tier2_quality, tc.image_quality) == (
        jc.roi_tier2_quality, jc.nonroi_tier2_quality, jc.image_quality
    )
    for size in (3 * 96 * 128, 3 * 512 * 768, 3 * 4000 * 6000, 1234):
        assert tcfg.min_region_size(size) == jcfg.min_region_size(size)
        assert tcfg.segment_window(size) == jcfg.segment_window(size)
    for q in (1.0, 10.0, 20.0, 40.0, 99.0, 100.0):
        for n in (1, 7, 64, 9999, 20000):
            assert dataclasses.asdict(tcfg.clustering_params(n, q)) == dataclasses.asdict(
                jcfg.clustering_params(n, q)
            )
            assert tcfg.kmeans_n_clusters(n, q) == jcfg.kmeans_n_clusters(n, q)
        for s in np.linspace(0, 1, 41):
            assert tcfg.logistic_segments(s, 57) == jcfg.logistic_segments(s, 57)
    for d in (64, 499, 500, 501, 768, 3000):
        assert tcfg.slic_scale_factor(d) == jcfg.slic_scale_factor(d)
    assert tcfg.KMEANS_SWITCH_COLORS == jcfg.KMEANS_SWITCH_COLORS


@pytest.mark.parametrize("level,use_rle", [(0, False), (7, False), (10, False), (0, True), (10, True)])
def test_container_pack_bytes_equal(rng, level, use_rle):
    for n_colors in (5, 300):
        palette = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
        idx = np.repeat(rng.integers(0, n_colors, (40, 7)), 9, axis=1).astype(np.int64)
        a = tcontainer.pack(palette, idx, level=level, use_rle=use_rle)
        b = jcontainer.pack(palette, idx, level=level, use_rle=use_rle)
        assert a == b
        dec = tcontainer.unpack(a)
        np.testing.assert_array_equal(dec.palette, palette)
        np.testing.assert_array_equal(dec.indices, idx)
        np.testing.assert_array_equal(dec.to_rgb(), palette[idx])
        np.testing.assert_array_equal(dec.to_rgb(), jcontainer.unpack(a).to_rgb())


def test_container_refuses_globals():
    import pickle
    import struct
    import zlib

    blob = zlib.compress(pickle.dumps({"s": (1, 1), "l": os.getpid}))
    with pytest.raises(pickle.UnpicklingError):
        tcontainer.unpack(b"RHCCQ" + struct.pack("<I", len(blob)) + blob)


def test_resize_matches_pil(rng):
    from PIL import Image

    from roibasedimagecompression_torch.models import segment as SEG

    for _ in range(12):
        h, w = int(rng.integers(20, 700)), int(rng.integers(20, 700))
        nh, nw = max(1, int(h * rng.uniform(0.2, 1.0))), max(1, int(w * rng.uniform(0.2, 1.0)))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[: h // 2] = (img[: h // 2] // 32) * 32  # flat-ish half
        want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        np.testing.assert_array_equal(SEG._resize_uint8(img, (nh, nw)), want)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_prng_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key), k)
    np.testing.assert_array_equal(np.asarray(jax.random.split(key)), prng.split(k))
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 5)), prng.split(k, 5))
    sub = jax.random.split(key)[1]
    s = prng.split(k)[1]
    for shape in ((1,), (1000,), (7, 9)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(sub, shape)), prng.uniform(s, shape)
        )
    # The Gumbel tail takes XLA's own float32 log (prng.log32): bit-exact.
    np.testing.assert_array_equal(
        prng.gumbel(s, (4096,)), np.asarray(jax.random.gumbel(sub, (4096,)))
    )


@pytest.mark.parametrize("seed", [0, 42, 4294967295])
def test_gumbel_table_is_jax_noise_of_the_split_chain(seed):
    """The k-means++ noise table (the plain version of the card's kernel) is
    the JAX package's draw: row i is jax.random.gumbel under the i-th sub-key
    of `key, sub = split(key)`."""
    from roibasedimagecompression_torch.ops import cluster as TCL

    key = jax.random.PRNGKey(seed)
    got = TCL._gumbel_table(seed, 1000, 6)
    for i in range(6):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.gumbel(sub, (1000,)))
        np.testing.assert_array_equal(got[i].view(np.int32), want.view(np.int32))


def test_prng_categorical_matches_jax(rng):
    for t in range(60):
        logits = np.log(rng.random(2048).astype(np.float32) * 1000.0 + 1e-20).astype(np.float32)
        logits[rng.random(2048) < 0.3] = -np.inf
        key = jax.random.PRNGKey(t)
        assert int(jax.random.categorical(key, logits)) == prng.categorical(prng.prng_key(t), logits)
