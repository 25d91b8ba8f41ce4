"""PyTorch port, Lloyd's assignment pass (`ops/cuda/lloyd_assign.py`,
`csrc/lloyd_assign.cu`): the launch plan and the wrapper's checks, the plain
version against the pass `kmeans_rows` ran before the kernel, the route
`kmeans_rows` takes and counts (`kmeans_assign.card` on a CUDA device,
`kmeans_assign.host` on the CPU) and, on a CUDA card, the kernel against the
plain version bit for bit and `kmeans_rows` / `kmeans_host_many` on the card
against their CPU labels, one launch an assignment pass.

Imports no JAX, so the card's machine runs it as it is:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_lloyd.py`.
"""

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.ops.cuda import kmeanspp as KPP
from roibasedimagecompression_torch.ops.cuda import lloyd_assign as LLOYD
from roibasedimagecompression_torch.utils import timing

from kmeans_cases import KMEANS_ROWS_CASES, kmeans_problem, weighted_problem

SEED = 42  # CodecConfig's k-means seed


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _count(name: str) -> int:
    return timing.counters().get(name, 0)


def _routes() -> tuple:
    return _count("kmeans_assign.card"), _count("kmeans_assign.host"), _count("kmeans_iters")


def _launches() -> int:
    return _build.launched["lloyd_assign"].total()


def _pre_change_assign(points, c, k, k_max):
    """The assignment pass of `kmeans_rows` before the kernel, frozen: the
    float64-emulated distances over chunks of points and `torch.argmin`."""
    b, m, _ = points.shape
    dev = points.device
    center_valid = torch.arange(k_max, device=dev)[None, :] < k[:, None]
    chunk = max(1, (1 << 23) // max(1, b * k_max))
    out = torch.empty((b, m), dtype=torch.int64, device=dev)
    for s in range(0, m, chunk):
        a = points[:, s : s + chunk]
        a2 = fma32(a[..., 2], a[..., 2], fma32(a[..., 1], a[..., 1], a[..., 0] * a[..., 0]))
        c2 = fma32(c[..., 2], c[..., 2], fma32(c[..., 1], c[..., 1], c[..., 0] * c[..., 0]))
        a_, c_ = a[:, :, None, :], c[:, None, :, :]
        ab = fma32(a_[..., 2], c_[..., 2], fma32(a_[..., 1], c_[..., 1], a_[..., 0] * c_[..., 0]))
        d2 = torch.clamp((a2[:, :, None] + c2[:, None, :]) - 2.0 * ab, min=0.0)
        d2 = torch.where(center_valid[:, None, :], d2, torch.full((), 3.4e38, device=dev))
        out[:, s : s + chunk] = torch.argmin(d2, dim=2)
    return out


def assign_problem(rng, b, m, k_max, ks, n_valid=None, dup=False):
    """Integer colours in clumps (padding zeroed past n_valid) and centres as
    Lloyd leaves them: float32 means of integer colour sums; with `dup`
    every odd centre repeats the one before it (exact ties)."""
    pts, valid = kmeans_problem(rng, b, m, [m] * b if n_valid is None else n_valid)
    counts = rng.integers(1, 300, (b, k_max, 1))
    sums = rng.integers(0, 256, (b, k_max, 3)) * counts + rng.integers(0, counts, (b, k_max, 3))
    centers = (sums.astype(np.float32) / counts.astype(np.float32)).astype(np.float32)
    if dup:
        centers[:, 1::2] = centers[:, 0:-1:2]
    return pts, valid, centers, np.asarray(ks, np.int64)


@pytest.mark.parametrize("b,m,k_max,split", [
    (1, 131_072, 1024, 4), (1, 16_384, 256, 8), (1, 32_768, 256, 8), (128, 1_024, 16, 1),
    (1, 65_536, 1024, 8), (8, 4_096, 128, 4), (1, 1, 2, 1), (200, 64, 64, 2), (1, 1_048_576, 32_768, 1),
])
def test_plan(b, m, k_max, split):
    """Groups a block: the fewest that give 3 blocks an SM of 132 while a
    group keeps at least 32 of a full bucket's centres; the blocks cover the
    row."""
    got, blocks = LLOYD.plan(b, m, k_max, 132)
    points = LLOYD._THREADS // got * LLOYD._PIX
    assert got == split and blocks * points >= m > (blocks - 1) * points


def test_assign_labels_checks_its_arguments():
    b, m, k_max = 2, 64, 8
    good = dict(points=torch.zeros((b, m, 3)), centers=torch.zeros((b, k_max, 3)),
                k=torch.full((b,), 3, dtype=torch.int64), k_max=k_max)
    bad = [
        {"points": torch.zeros((b, m, 3)).double()}, {"points": torch.zeros((b, m))},
        {"points": torch.zeros((b, m, 4))}, {"points": torch.zeros((b, m, 6))[..., ::2]},
        {"points": torch.zeros((0, m, 3)), "centers": torch.zeros((0, k_max, 3)),
         "k": torch.zeros(0, dtype=torch.int64)},
        {"centers": torch.zeros((b, k_max + 1, 3))}, {"centers": torch.zeros((b, k_max, 3)).half()},
        {"centers": torch.zeros((b, 3, k_max)).transpose(1, 2)},
        {"k": torch.full((b,), 3, dtype=torch.int32)}, {"k": torch.full((b + 1,), 3, dtype=torch.int64)},
        {"k_max": 0, "centers": torch.zeros((b, 0, 3))},
        {"k_max": 2.0},
        {"points": torch.zeros((b, m, 3), device="meta"), "centers": torch.zeros((b, k_max, 3), device="meta"),
         "k": torch.full((b,), 3, dtype=torch.int64, device="meta")},
        {"k": torch.full((b,), 3, dtype=torch.int64, device="meta")},
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            LLOYD.assign_labels(**(good | change))
    assert LLOYD.assign_labels(**good).dtype == torch.int64


@pytest.mark.parametrize("ks,k_max,m", KMEANS_ROWS_CASES)
@pytest.mark.parametrize("dup", [False, True])
def test_assign_plain_is_the_pass_before_the_kernel(ks, k_max, m, dup):
    """`assign_plain`, and `assign_labels` on the CPU, give the labels of the
    pass `kmeans_rows` ran before the kernel, over several chunks at k_max
    1024, with padded points, rows of k < k_max and ties."""
    rng = np.random.default_rng(k_max + m)
    pts, valid, centers, k = assign_problem(rng, len(ks), m, k_max, ks, [m, m - 100, m // 2], dup)
    args = [torch.from_numpy(x) for x in (pts, centers, k)]
    want = _pre_change_assign(*args, k_max)
    np.testing.assert_array_equal(LLOYD.assign_plain(*args, k_max).numpy(), want.numpy())
    np.testing.assert_array_equal(LLOYD.assign_labels(*args, k_max).numpy(), want.numpy())
    assert (want.numpy() < k[:, None]).all()


def test_assign_plain_edge_rows():
    """A row with no valid centre (k 0, or k below 0) labels every point 0; a
    k above k_max counts as k_max; a tie goes to the first index."""
    pts = torch.tensor([[[0.0, 0, 0], [10, 10, 10], [5, 5, 5]]] * 4)
    c = torch.tensor([[[10.0, 10, 10], [0, 0, 0], [0, 0, 0], [5, 5, 5]]] * 4)
    got = LLOYD.assign_plain(pts, c, torch.tensor([0, -1, 9, 3]), 4).numpy()
    np.testing.assert_array_equal(got, [[0, 0, 0], [0, 0, 0], [1, 0, 3], [1, 0, 0]])


def test_kmeans_rows_on_the_cpu_assigns_on_the_host():
    """On the CPU every assignment pass, each Lloyd pass and the last, is
    counted as `kmeans_assign.host`, and nothing launches."""
    ks, k_max, m = KMEANS_ROWS_CASES[0]
    rng = np.random.default_rng(0)
    pts, valid = kmeans_problem(rng, len(ks), m, [m, m - 100, m // 2])
    for kw in ({}, {"plusplus": False}, {"iters": 1}):
        before, launches = _routes(), _launches()
        TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
                        seed=SEED, **kw)
        card, host, iters = (a - b for a, b in zip(_routes(), before))
        assert (card, host, _launches()) == (0, iters + 1, launches) and iters >= 1


@pytest.mark.parametrize("weighted", [False, True])
def test_assign_route_on_a_cuda_device(monkeypatch, weighted):
    """On a CUDA device (here the CPU, asked as one) every assignment pass,
    weighted or not, takes the kernel's wrapper once with the whole batch,
    counted as `kmeans_assign.card`; the labels are the CPU route's."""
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

    def kernel(points, centers, k, k_max):
        calls.append((tuple(points.shape), tuple(centers.shape), k.tolist(), k_max))
        assert points.is_contiguous() and centers.is_contiguous() and k.dtype == torch.int64
        return LLOYD.assign_plain(points, centers, k, k_max)

    def seeding(points, valid, k, noise, log_table, k_max, weights=None):
        return TCL._plusplus_loop(points, valid, k, noise, log_table, k_max)

    monkeypatch.setattr(TCL, "_on_card", lambda dev: True)
    monkeypatch.setattr(KPP, "kmeanspp_centers", seeding)
    monkeypatch.setattr(LLOYD, "assign_labels", kernel)
    before = _routes()
    got = run()
    np.testing.assert_array_equal(got, want)
    card, host, iters = (a - b for a, b in zip(_routes(), before))
    assert (card, host) == (iters + 1, 0) and len(calls) == card
    assert all(c == ((3, m, 3), (3, k_max, 3), list(ks), k_max) for c in calls)


def test_the_kernel_is_registered():
    """The build and the launch record know kernel 6: its source, its launch
    function's nine arguments (pointers, sizes, split, stream) and an empty
    record to start from."""
    assert "lloyd_assign" in _build.KERNELS
    assert list(_build._LAUNCHERS["lloyd_assign"]) == ["lloyd_assign_launch"]
    assert len(_build._LAUNCHERS["lloyd_assign"]["lloyd_assign_launch"]) == 9
    with open(f"{_build.CSRC}/lloyd_assign.cu") as f:
        assert "lloyd_assign_launch" in f.read()


# (B, m, k_max, k a row, n_valid a row or None, duplicate centres): tier 1's
# CLIC row and Kodak rows, a split bucket with a per-row k, rows of k < k_max
# with padding, ties, and k_max 4096 (several centre tiles).
CARD_CASES = [
    (1, 131_072, 1024, [900], None, False),
    (1, 16_384, 256, [142], [10_000], False),
    (1, 32_768, 256, [189], [20_000], False),
    (128, 1_024, 16, "2-16", "ragged", False),
    (3, 4_096, 512, [300, 280, 400], [4_096, 3_000, 100], True),
    (2, 8_192, 4_096, [4_096, 2_500], [8_192, 5_000], False),
    (4, 2_048, 64, [0, 64, 1, 33], None, True),
]


def _card_case(rng, b, m, k_max, ks, n_valid, dup):
    if ks == "2-16":
        ks = rng.integers(2, 17, b)
    if n_valid == "ragged":
        n_valid = rng.integers(2, m + 1, b)
    return assign_problem(rng, b, m, k_max, ks, n_valid, dup)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k_max,ks,n_valid,dup", CARD_CASES)
def test_cuda_kernel_is_the_plain_version(cuda, b, m, k_max, ks, n_valid, dup):
    """The kernel's labels against the plain version's on the card, bit for
    bit, in one launch recorded under (B, m, k_max)."""
    rng = np.random.default_rng(b * m + k_max)
    pts, valid, centers, k = _card_case(rng, b, m, k_max, ks, n_valid, dup)
    args = [torch.from_numpy(x).to(cuda) for x in (pts, centers, k)]
    before = _launches(), _build.launched["lloyd_assign"][(b, m, k_max)]
    got = LLOYD.assign_labels(*args, k_max)
    assert (_launches(), _build.launched["lloyd_assign"][(b, m, k_max)]) == (before[0] + 1, before[1] + 1)
    want = LLOYD.assign_plain(*args, k_max)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("ks,k_max,m", KMEANS_ROWS_CASES)
def test_cuda_kmeans_rows_assign_with_the_kernel(cuda, ks, k_max, m):
    """`kmeans_rows` on the card gives the CPU's labels; every assignment
    pass is one launch over the whole batch, counted as `kmeans_assign.card`,
    and none takes the host."""
    rng = np.random.default_rng(9)
    pts, valid = kmeans_problem(rng, len(ks), m, [m, m - 100, m // 2])
    want = TCL.kmeans_rows(torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
                           iters=10, seed=SEED).numpy()
    before, launches = _routes(), _build.launched["lloyd_assign"][(len(ks), m, k_max)]
    got = TCL.kmeans_rows(torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda), np.array(ks),
                          k_max=k_max, iters=10, seed=SEED).cpu().numpy()
    card, host, iters = (a - b for a, b in zip(_routes(), before))
    assert (card, host) == (iters + 1, 0)
    assert _build.launched["lloyd_assign"][(len(ks), m, k_max)] - launches == card
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_kmeans_host_many_assigns_with_the_kernel(cuda):
    """Tier 1's entry: one launch an assignment pass of every problem, the
    k <= 1 problem none; labels equal to the CPU's."""
    rng = np.random.default_rng(13)
    problems = [(rng.integers(0, 256, (n, 3)).astype(np.float32), k)
                for n, k in ((10_000, 142), (20_000, 189), (3_000, 40), (50, 1))]
    want = TCL.kmeans_host_many(problems, "cpu", seed=SEED)
    before, launches = _routes(), _launches()
    got = TCL.kmeans_host_many(problems, cuda, seed=SEED)
    card, host, iters = (a - b for a, b in zip(_routes(), before))
    assert (card, host, _launches() - launches) == (iters + 3, 0, card)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
