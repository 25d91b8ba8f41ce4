"""PyTorch port, the k-means++ noise (`ops/cuda/gumbel.py`, `csrc/gumbel.cu`):
the prefix property of partitionable threefry that the card path rests on,
the per-seed chain of sub-keys and, on a CUDA card, the kernel against its
plain version, the host table (`ops/cluster.py _gumbel_table`), and
`kmeans_rows` on the card against its CPU labels.  (`tests/test_torch_base.py`
holds the host table to the JAX package's draws.)

Imports no JAX, so the card's machine runs it as it is:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gumbel.py`.
"""

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops.cuda import gumbel as GUMBEL
from roibasedimagecompression_torch.utils import timing

from kmeans_cases import KMEANS_ROWS_CASES, WEIGHTED_ROWS_CASES, kmeans_problem, weighted_problem

SEEDS = [0, 42, 4294967295]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_table_is_a_prefix_of_a_larger_one(seed):
    """Element (i, j) depends on sub-key i and on j alone: every table of a
    seed is the corner of any larger one."""
    big = TCL._gumbel_table(seed, 300, 12)
    for m, n in ((1, 1), (8, 3), (299, 12), (300, 5), (17, 11)):
        np.testing.assert_array_equal(_bits(TCL._gumbel_table(seed, m, n)), _bits(big[:n, :m]))


@pytest.mark.parametrize("seed", SEEDS)
def test_subkey_chain_is_the_split_loop(seed):
    key = prng.prng_key(seed)
    want = []
    for _ in range(20):
        key, sub = prng.split(key)
        want.append(sub)
    want = np.stack(want)
    np.testing.assert_array_equal(prng.subkey_chain(seed, 20), want)
    keys = GUMBEL.subkeys(seed, 20, "cpu")
    assert keys.dtype == torch.int32 and keys.shape[0] >= 20
    np.testing.assert_array_equal(keys[:20].numpy().view(np.uint32), want)
    assert GUMBEL.subkeys(seed, 3, "cpu") is keys  # one chain a seed and device
    # Past the codec's widest call a chain is made for the call and not kept.
    longer = GUMBEL.subkeys(seed, 300, "cpu")
    assert longer.shape[0] >= 300 and GUMBEL.subkeys(seed, 300, "cpu") is not longer
    np.testing.assert_array_equal(longer[: keys.shape[0]].numpy(), keys.numpy())
    assert GUMBEL.subkeys(seed, 20, "cpu") is keys


def test_gumbel_rows_checks_its_arguments():
    keys = GUMBEL.subkeys(42, 4, "cpu")[:4]
    # The last: a CPU tensor (the CPU's noise is the host table).
    for bad_keys, m in ((keys[:, :1], 8), (keys.float(), 8), (keys[0], 8), (keys, 0), (keys, 8)):
        with pytest.raises(ValueError):
            GUMBEL.gumbel_rows(bad_keys, m)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", [8, 1000, 16384, 131072])
def test_cuda_gumbel_table_is_the_host_table(cuda, seed, m):
    for n in (1, 3, 256):
        before = GUMBEL.launches, GUMBEL.launch_shapes[(seed, n, m)]
        got = GUMBEL.gumbel_table(seed, m, n, cuda)
        assert (GUMBEL.launches, GUMBEL.launch_shapes[(seed, n, m)]) == (before[0] + 1, before[1] + 1)
        want = TCL._gumbel_table(seed, m, n)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (n, m)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    TCL._gumbel_table.cache_clear()


def _count(name: str) -> int:
    return timing.counters().get(name, 0)


def _card_and_cpu(cuda, pts, valid, ks, k_max, **kw):
    """Labels of kmeans_rows on the card and on the CPU; the card's call
    counts one `kmeans_noise.card` seeding where it draws k-means++ noise."""
    plusplus = kw.get("plusplus", True)
    want = TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks),
                           k_max=k_max, iters=10, seed=42, **kw).numpy()
    cw = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in kw.items()}
    before = (_count("kmeans_noise.card"), _count("kmeans_noise.host"))
    got = TCL.kmeans_rows(torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda),
                          np.array(ks), k_max=k_max, iters=10, seed=42, **cw).cpu().numpy()
    assert (_count("kmeans_noise.card"), _count("kmeans_noise.host")) == (
        before[0] + int(plusplus), before[1])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("ks,k_max,m", KMEANS_ROWS_CASES)
def test_cuda_kmeans_rows_match_cpu(cuda, ks, k_max, m):
    """The cases of test_kmeans_rows_match_jax (their CPU labels are the JAX
    package's)."""
    rng = np.random.default_rng(0)
    pts, valid = kmeans_problem(rng, len(ks), m, [m, m - 100, m // 2])
    got, want = _card_and_cpu(cuda, pts, valid, ks, k_max, plusplus=k_max <= 256)
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.cuda
@pytest.mark.parametrize("ks,k_max,m,w_max", WEIGHTED_ROWS_CASES)
def test_cuda_weighted_kmeans_rows_match_cpu(cuda, ks, k_max, m, w_max):
    """The cases of test_weighted_kmeans_rows_match_jax."""
    rng = np.random.default_rng(m + len(ks))
    pts, valid, w = weighted_problem(rng, len(ks), m, [m, m - 10, m // 2], w_max)
    got, want = _card_and_cpu(cuda, pts, valid, ks, k_max, plusplus=True,
                              weights=torch.from_numpy(w))
    np.testing.assert_array_equal(got[valid], want[valid])
