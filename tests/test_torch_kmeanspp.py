"""PyTorch port, the k-means++ seeding (`ops/cuda/kmeanspp.py`,
`csrc/kmeanspp.cu`): the launch plan and the wrapper's checks, the route
`kmeans_rows` takes and counts (`kmeans_seed.kernel` on a CUDA device,
`kmeans_seed.loop` on the CPU and for weighted seeding), the plain loop's
contract and, on a CUDA card, the kernel against the plain loop
(`ops/cluster.py _plusplus_loop`) bit for bit and `kmeans_rows` on the card
against its CPU labels.

Imports no JAX, so the card's machine runs it as it is:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kmeanspp.py`.
"""

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.ops.cuda import gumbel as GUMBEL
from roibasedimagecompression_torch.ops.cuda import kmeanspp as KPP
from roibasedimagecompression_torch.utils import timing

from kmeans_cases import (KMEANS_ROWS_CASES, KMEANSPP_CASES, kmeans_problem, seeding_problem,
                          weighted_problem)

SEED = 42  # CodecConfig's k-means seed


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _count(name: str) -> int:
    return timing.counters().get(name, 0)


def _seedings() -> tuple:
    return _count("kmeans_seed.kernel"), _count("kmeans_seed.loop")


def _launches(name: str = "kmeanspp") -> int:
    return _build.launched[name].total()


def _bits(x) -> np.ndarray:
    return x.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("m", [1, 8, 64, 1000, 1024, 4096, 4097, 16_384, 32_768, 65_536,
                               131_072, 262_144, 2**31 - 1])
def test_plan_covers_the_row(m):
    """One block a row up to 4,096 points, clusters of up to 16 blocks above;
    the blocks cover the row, and a slice beyond shared memory streams."""
    cluster, threads, slice_, on_chip = KPP.plan(m)
    assert 1 <= cluster <= 16 and cluster * slice_ >= m > (cluster - 1) * slice_
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert on_chip == (slice_ <= KPP._ON_CHIP)
    if m <= KPP._NARROW:
        assert (cluster, slice_) == (1, m) and threads >= min(1024, -(-m // 4))
    else:
        assert threads == 1024 and cluster == min(16, -(-m // KPP._NARROW))
    assert KPP.plan(16_384)[0] == 4 and KPP.plan(32_768)[0] == 8 and KPP.plan(65_536)[0] == 16


def test_kmeanspp_centers_checks_its_arguments():
    b, m, n = 2, 64, 4
    pts = torch.zeros((b, m, 3))
    valid = torch.ones((b, m), dtype=torch.bool)
    k = torch.full((b,), 3, dtype=torch.int64)
    noise = torch.zeros((n, m))
    table = TCL._log32_table(torch.device("cpu"))
    good = dict(points=pts, valid=valid, k=k, noise=noise, log_table=table, k_max=4)
    bad = [
        {},  # the CPU: it seeds with the plain loop
        {"weights": torch.ones((b, m))},
        {"points": pts[..., :2].contiguous()}, {"points": pts.double()}, {"points": pts[0]},
        {"points": torch.zeros((b, m, 6))[..., ::2]},
        {"valid": valid.int()}, {"valid": valid[:, :-1].contiguous()},
        {"k": k.int()}, {"k": k[:1]}, {"noise": noise[:, :-1].contiguous()},
        {"noise": torch.zeros((m, n)).t()}, {"noise": noise[:0]},
        {"log_table": table.double()}, {"log_table": table[None]}, {"k_max": 0},
        {"points": torch.zeros((0, m, 3))},
    ]
    for change in bad:
        with pytest.raises(ValueError):
            KPP.kmeanspp_centers(**(good | change))


@pytest.mark.parametrize("ks,k_max,m", KMEANS_ROWS_CASES[:1])
def test_kmeans_rows_on_the_cpu_seeds_with_the_loop(ks, k_max, m):
    rng = np.random.default_rng(0)
    pts, valid = kmeans_problem(rng, len(ks), m, [m, m - 100, m // 2])
    before, launches = _seedings(), _launches()
    TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
                    iters=2, seed=SEED)
    assert _seedings() == (before[0], before[1] + 1) and _launches() == launches
    # The seeded random start and given centres seed nothing.
    for kw in ({"plusplus": False}, {"init_centers": torch.zeros((len(ks), k_max, 3))}):
        TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
                        iters=2, seed=SEED, **kw)
    assert _seedings() == (before[0], before[1] + 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_seeding_route_on_a_cuda_device(monkeypatch, weighted):
    """On a CUDA device (here the CPU, asked as one) unweighted seeding takes
    the kernel, once, and weighted seeding the plain loop; the labels are the
    CPU route's either way."""
    rng = np.random.default_rng(5)
    ks, k_max, m = (5, 9, 2), 16, 256
    if weighted:
        pts, valid, w = weighted_problem(rng, 3, m, [m, m - 10, m // 2], 300)
        kw = {"weights": torch.from_numpy(w)}
    else:
        pts, valid = kmeans_problem(rng, 3, m, [m, m - 10, m // 2])
        kw = {}

    def run():
        return TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks),
                               k_max=k_max, iters=5, seed=SEED, **kw).numpy()

    want = run()
    calls = []

    def kernel(points, valid, k, noise, log_table, k_max, weights=None):
        calls.append(points.shape)
        return TCL._plusplus_loop(points, valid, k, noise, log_table, k_max)

    monkeypatch.setattr(TCL, "_on_card", lambda dev: True)
    monkeypatch.setattr(KPP, "kmeanspp_centers", kernel)
    before = _seedings()
    got = run()
    np.testing.assert_array_equal(got, want)
    assert len(calls) == (0 if weighted else 1)
    assert _seedings() == ((before[0], before[1] + 1) if weighted else (before[0] + 1, before[1]))


@pytest.mark.parametrize("b,m,k_max,kind", [c for c in KMEANSPP_CASES if c[0] * c[1] <= 16_384])
def test_plusplus_loop_contract(b, m, k_max, kind):
    """What the kernel reproduces: centre 0 in every row, whatever its k;
    centre i a point of the row for i < min(k, n_draws); zeros past it."""
    rng = np.random.default_rng(b + m + k_max)
    pts, valid, ks = seeding_problem(rng, b, m, k_max, kind)
    ks[-1] = 0
    n_draws = max(int(ks.max()), 1)
    noise = torch.from_numpy(TCL._gumbel_table(SEED, m, n_draws).copy())
    c = TCL._plusplus_loop(torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(ks),
                           noise, TCL._log32_table(torch.device("cpu")), k_max).numpy()
    for r in range(b):
        steps = max(1, min(int(ks[r]), n_draws))
        assert not c[r, steps:].any()
        row = {tuple(p) for p in pts[r]}
        assert all(tuple(x) in row for x in c[r, :steps])


def _noise(kind, m, n_draws, dev):
    noise = GUMBEL.gumbel_table(SEED, m, n_draws, dev)
    return torch.round(noise * 4) / 4 if kind == "ties" else noise  # many exact ties


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k_max,kind", KMEANSPP_CASES)
def test_cuda_kmeanspp_centers_are_the_loop(cuda, b, m, k_max, kind):
    """The kernel against the plain loop on the card, bit for bit, one launch."""
    rng = np.random.default_rng(b * m + k_max)
    pts, valid, ks = seeding_problem(rng, b, m, k_max, kind)
    args = [torch.from_numpy(x).to(cuda) for x in (pts, valid, ks)]
    noise = _noise(kind, m, max(int(ks.max()), 1), cuda)
    table = TCL._log32_table(cuda)
    key = (b, m, noise.shape[0], k_max)
    before = _launches(), _build.launched["kmeanspp"][key]
    got = KPP.kmeanspp_centers(*args, noise, table, k_max)
    assert (_launches(), _build.launched["kmeanspp"][key]) == (before[0] + 1, before[1] + 1)
    want = TCL._plusplus_loop(*args, noise, table, k_max)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("rows", c) for c in KMEANS_ROWS_CASES if c[1] <= 256]
                         + [("seeding", c) for c in KMEANSPP_CASES if c[0] * c[1] <= 65_536])
def test_cuda_kmeans_rows_seed_with_the_kernel(cuda, case):
    """`kmeans_rows` on the card gives the CPU's labels; each seeding is one
    launch, counted once as `kmeans_seed.kernel` beside one card noise draw,
    and never as `kmeans_seed.loop`."""
    source, c = case
    rng = np.random.default_rng(7)
    if source == "rows":
        ks, k_max, m = c
        pts, valid = kmeans_problem(rng, len(ks), m, [m, m - 100, m // 2])
        ks = np.array(ks)
    else:
        b, m, k_max, kind = c
        pts, valid, ks = seeding_problem(rng, b, m, k_max, kind)
    want = TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), ks, k_max=k_max, iters=10,
                           seed=SEED).numpy()
    before = _seedings(), _launches(), _launches("gumbel")
    got = TCL.kmeans_rows(torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda), ks,
                          k_max=k_max, iters=10, seed=SEED).cpu().numpy()
    after = _seedings(), _launches(), _launches("gumbel")
    assert after == ((before[0][0] + 1, before[0][1]), before[1] + 1, before[2] + 1)
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.cuda
def test_cuda_weighted_seeding_takes_the_loop(cuda):
    rng = np.random.default_rng(11)
    ks, k_max, m = (5, 9, 2), 16, 256
    pts, valid, w = weighted_problem(rng, 3, m, [m, m - 10, m // 2], 300)
    before = _seedings(), _launches()
    TCL.kmeans_rows(torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda), np.array(ks),
                    k_max=k_max, iters=5, seed=SEED, weights=torch.from_numpy(w).to(cuda))
    assert (_seedings(), _launches()) == ((before[0][0], before[0][1] + 1), before[1])


@pytest.mark.cuda
def test_cuda_kmeans_host_many_launches_once_a_seeding(cuda):
    """Tier 1's entry: every k-means++ problem one launch; the k <= 1 problem
    none; labels equal to the CPU's."""
    rng = np.random.default_rng(13)
    problems = [(rng.integers(0, 256, (n, 3)).astype(np.float32), k)
                for n, k in ((10_000, 142), (20_000, 189), (3_000, 40), (50, 1))]
    want = TCL.kmeans_host_many(problems, "cpu", seed=SEED)
    before = _seedings(), _launches()
    got = TCL.kmeans_host_many(problems, cuda, seed=SEED)
    assert (_seedings(), _launches()) == ((before[0][0] + 3, before[0][1]), before[1] + 3)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
