"""PyTorch port, kernels and clustering: the plain versions of the two CUDA
kernels against the JAX package's Pallas kernels (interpret mode) and XLA
paths, the eps driver against the host union-find, and batched k-means
against the JAX kernel.  The CUDA tests run the kernels themselves and skip
without a card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roibasedimagecompression_tpu import native as jnative
from roibasedimagecompression_tpu.ops import cluster as JCL
from roibasedimagecompression_tpu.ops.pallas import epscc as JEPS
from roibasedimagecompression_tpu.ops.pallas import slic_assign as JSA
from roibasedimagecompression_torch import native as tnative
from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops import slic as TSLIC
from roibasedimagecompression_torch.ops.cuda import epscc as TEPS
from roibasedimagecompression_torch.ops.cuda import slic_assign as TSA

from kmeans_cases import KMEANS_ROWS_CASES, kmeans_problem


@pytest.fixture()
def one_thread():
    """Runs a test's torch work on one thread and restores the count after:
    the suite runs several worker processes on the host's cores, and a torch
    thread pool per worker only adds contention to these encode-heavy tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _near_tie_problem(rng, mp, k, scale):
    """Random features and centres whose second half repeats the first half
    moved by a few 1e-5: many pixels then have two candidates within an ulp
    or two of each other, where a different rounding would flip the id."""
    feats = (rng.random((mp, 5)) * scale).astype(np.float32)
    centers = (rng.random((k, 5)) * scale).astype(np.float32)
    centers[k // 2 :] = centers[: k - k // 2] + rng.integers(-2, 3, (k - k // 2, 5)).astype(
        np.float32
    ) * np.float32(1e-5)
    return feats, centers


@pytest.mark.parametrize("seed,k,scale", [(0, 64, 100.0), (1, 256, 100.0), (2, 64, 1.0)])
def test_slic_assign_plain_matches_pallas(seed, k, scale):
    """No tie allowance: the plain version rounds where XLA's CPU code for the
    Pallas kernel rounds, so every id is equal, near-ties included."""
    feats, centers = _near_tie_problem(np.random.default_rng(seed), 40960, k, scale)
    want = np.asarray(JSA.slic_assign_pallas(jnp.asarray(feats), jnp.asarray(centers), interpret=True))
    got = TSA.slic_assign(torch.from_numpy(feats)[None], torch.from_numpy(centers)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_slic_assign_plain_sentinel(rng):
    feats = rng.random((2, 2048, 5)).astype(np.float32)
    centers = np.full((2, 8, 5), 1e6, np.float32)
    centers[:, :3] = rng.random((2, 3, 5)).astype(np.float32)
    got = TSA.slic_assign(torch.from_numpy(feats), torch.from_numpy(centers)).numpy()
    assert got.max() < 3
    for b in range(2):
        want = np.asarray(JSA.slic_assign_pallas(jnp.asarray(feats[b]), jnp.asarray(centers[b]), interpret=True))
        np.testing.assert_array_equal(got[b], want)


def _eps_setup(rng, n=700, npad=1024):
    pts = np.unique(rng.integers(0, 256, (n, 3), dtype=np.int32), axis=0).astype(np.float32)
    m = len(pts)
    P = np.zeros((npad, 3), np.float32)
    P[:m] = pts
    valid = np.zeros(npad, bool)
    valid[:m] = True
    return P, valid, m


@pytest.mark.parametrize("eps", [10.0, 51.2, 102.4])
def test_eps_plain_matches_pallas_xla_and_native(rng, eps):
    P, valid, m = _eps_setup(rng)
    groups = np.zeros(len(P), np.int32)
    groups[m // 2 :] = 7
    jp = (jnp.asarray(P), jnp.float32(eps), jnp.asarray(valid), jnp.asarray(groups))
    want_pallas = np.asarray(JEPS.eps_components_pallas(*jp, interpret=True))
    want_xla = np.asarray(JCL.eps_components(*jp, chunk=512))
    got = TCL.eps_components(P, eps, valid, groups).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    # One sweep on its own against the Pallas sweep.
    eps2 = np.float32(eps) ** 2
    lab = np.where(valid, np.arange(len(P)), 2**31 - 1).astype(np.int32)
    g = np.where(valid, groups, -1).astype(np.int32)
    one_j = np.asarray(JEPS.eps_sweep_pallas(
        jnp.asarray(P), jnp.asarray(lab), jnp.asarray(valid), jnp.asarray(g),
        jnp.float32(eps2), interpret=True,
    ))
    one_t = TEPS.eps_sweep(
        torch.from_numpy(P)[None], torch.from_numpy(lab)[None],
        torch.from_numpy(valid.astype(np.uint8))[None], torch.from_numpy(g)[None],
        torch.tensor([eps2]),
    )[0].numpy()
    np.testing.assert_array_equal(one_t[valid], one_j[valid])
    # The host union-find on the same two runs (one per group).
    packed = ((P[:m, 0].astype(np.int64) << 16) | (P[:m, 1].astype(np.int64) << 8)
              | P[:m, 2].astype(np.int64)).astype(np.int32)
    h = m // 2
    nat = tnative.epscc_labels_runs(packed, np.array([0, h]), np.array([h, m - h]), np.array([eps, eps]))
    np.testing.assert_array_equal(nat[:h], got[:h])
    np.testing.assert_array_equal(nat[h:] + h, got[h:m])
    np.testing.assert_array_equal(
        nat, jnative.epscc_labels_runs(packed, np.array([0, h]), np.array([h, m - h]), np.array([eps, eps]))
    )


def test_eps_rows_driver_batched(rng):
    """Several bucket rows at once, with per-row eps and ragged sizes, equal
    the per-row Pallas driver."""
    b, n = 5, 256
    P = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), bool)
    eps = np.array([10.0, 25.6, 51.2, 76.8, 102.4])
    for r in range(b):
        pts = np.unique(rng.integers(0, 256, (int(rng.integers(20, n)), 3)), axis=0)
        P[r, : len(pts)] = pts
        valid[r, : len(pts)] = True
    eps2 = (eps.astype(np.float32) ** 2).astype(np.float32)
    got, sweeps = TEPS.eps_components_rows(
        torch.from_numpy(P), torch.from_numpy(valid), torch.zeros((b, n), dtype=torch.int32),
        torch.from_numpy(eps2),
    )
    assert sweeps >= 1
    for r in range(b):
        want = np.asarray(JEPS.eps_components_pallas(
            jnp.asarray(P[r]), jnp.float32(eps[r]), jnp.asarray(valid[r]), None, interpret=True
        ))
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("q0", [1, 26, 51, 76])
def test_packed_adjacency_matches_float(rng, q0):
    """The kernel's integer predicate (byte-wise |a - b|, dot with itself,
    <= floor(eps2)) against the float32 predicate of eps_sweep_ref, for every
    eps of the quality law 128 - 1.28 q (eps == 0 -> 1.0)."""
    n = 192
    cols = rng.integers(0, 256, (n, 3))
    cols[:4] = [[0, 0, 0], [255, 255, 255], [0, 255, 0], [255, 0, 255]]
    base = cols[rng.integers(0, n, n // 2)]
    cols[n // 2 :] = np.clip(base + rng.integers(-70, 71, base.shape), 0, 255)
    packed = torch.from_numpy((cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)).astype(np.int32))
    pts = torch.from_numpy(cols.astype(np.float32))[None]
    lab = torch.arange(n, dtype=torch.int32)[None]
    ones = torch.ones((1, n), dtype=torch.uint8)
    zeros = torch.zeros((1, n), dtype=torch.int32)
    for q in range(q0, q0 + 25):
        eps = 128.0 - 1.28 * q
        eps = 1.0 if eps == 0 else eps
        eps2 = torch.tensor([np.float32(eps) ** 2], dtype=torch.float32)
        adj = TEPS.packed_adjacency(packed[:, None], packed[None, :], eps2[0])
        # The float32 predicate, computed as eps_sweep_ref computes it; the
        # last assert ties it to eps_sweep_ref's own output.
        d2 = torch.zeros((n, n), dtype=torch.float32)
        for ch in range(3):
            diff = pts[0, :, ch, None] - pts[0, None, :, ch]
            d2 = d2 + diff * diff
        want = d2 <= eps2[0]
        assert torch.equal(adj, want), q
        got = torch.where(adj, lab, torch.full_like(lab, TEPS.INT_MAX)).min(dim=1).values
        assert torch.equal(got.int(), TEPS.eps_sweep_ref(pts, lab, ones, zeros, eps2)[0]), q


def _old_driver(points, valid, groups, eps2):
    """The out-of-place loop the port shipped first: sweep every row, combine,
    ceil(log2 n) pointer hops, until nothing changes."""
    b, n = valid.shape
    groups = torch.where(valid, groups, torch.full_like(groups, -1))
    int_max = torch.full((b, n), TEPS.INT_MAX, dtype=torch.int32)
    lab = torch.where(valid, torch.arange(n, dtype=torch.int32).expand(b, n), int_max)
    for _ in range(n):
        proposed = TEPS.eps_sweep_ref(points, lab, valid.to(torch.uint8), groups, eps2)
        new = torch.where(valid, torch.minimum(lab, proposed), int_max)
        for _ in range(max(1, (n - 1).bit_length())):
            safe = torch.where(new < n, new, torch.zeros_like(new)).long()
            new = torch.where(valid, torch.minimum(new, torch.gather(new, 1, safe)), int_max)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(lab == TEPS.INT_MAX, torch.full_like(lab, n), lab)


def test_eps_new_loop_matches_old_driver_pallas_and_native(rng):
    """Ragged rows with two groups each: the loop with frozen rows, root
    hooking and root chasing gives the labels of the old out-of-place driver,
    of the Pallas driver and of the host union-find; one more round on the
    converged labels changes nothing."""
    b, n = 4, 300
    eps = np.array([12.8, 51.2, 64.0, 102.4])
    P = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), bool)
    groups = np.full((b, n), -1, np.int32)
    sizes = []
    for r in range(b):
        pts = np.unique(rng.integers(0, 256, (int(rng.integers(40, n)), 3)), axis=0)
        m = len(pts)
        sizes.append(m)
        P[r, :m] = pts
        valid[r, :m] = True
        groups[r, :m] = np.where(np.arange(m) < m // 2, 0, 5)
    eps2 = torch.from_numpy((eps.astype(np.float32) ** 2).astype(np.float32))
    args = (torch.from_numpy(P), torch.from_numpy(valid), torch.from_numpy(groups), eps2)
    got, sweeps = TEPS.eps_components_rows(*args)
    assert 1 <= sweeps < n
    assert torch.equal(got, _old_driver(*args))
    for r in range(b):
        want = np.asarray(JEPS.eps_components_pallas(
            jnp.asarray(P[r]), jnp.float32(eps[r]), jnp.asarray(valid[r]), jnp.asarray(groups[r]),
            interpret=True,
        ))
        np.testing.assert_array_equal(got[r].numpy(), want)
        m, h = sizes[r], sizes[r] // 2
        packed = ((P[r, :m, 0].astype(np.int64) << 16) | (P[r, :m, 1].astype(np.int64) << 8)
                  | P[r, :m, 2].astype(np.int64)).astype(np.int32)
        nat = tnative.epscc_labels_runs(packed, np.array([0, h]), np.array([h, m - h]), np.array([eps[r]] * 2))
        np.testing.assert_array_equal(nat[:h], got[r, :h].numpy())
        np.testing.assert_array_equal(nat[h:] + h, got[r, h:m].numpy())
    # Extra rounds after convergence, on every row, change nothing.
    lab = torch.where(args[1], got, torch.full_like(got, TEPS.INT_MAX))
    g = torch.where(args[1], args[2], torch.full_like(args[2], -1))
    for _ in range(2):
        again, changed = TEPS.plain_round(args[0], lab, args[1], g, eps2, torch.ones(b, dtype=torch.bool))
        assert not bool(changed.any())
        assert torch.equal(again, lab)


def test_eps_components_packed_matches_union_find(rng):
    """The one-upload form (packed colours, -1 where absent, validity derived
    from the rows) on the bucket layout of the tiers, against the union-find."""
    from roibasedimagecompression_torch.models import quantize_batched as QB

    runs = [np.unique(rng.integers(0, 256, (int(m), 3)), axis=0) for m in (50, 3, 64, 17)]
    colors = np.concatenate(runs)
    packed = ((colors[:, 0] << 16) | (colors[:, 1] << 8) | colors[:, 2]).astype(np.int32)
    sizes = np.array([len(r) for r in runs])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    eps = np.array([64.0, 1.0, 25.6, 115.2])
    want = tnative.epscc_labels_runs(packed, starts, sizes, eps)
    got = QB._epscc_labels_device(packed, starts, sizes, eps, 64, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks,k_max,m", KMEANS_ROWS_CASES)
def test_kmeans_rows_match_jax(rng, ks, k_max, m):
    b = len(ks)
    n_valid = [m, m - 100, m // 2]
    pts, valid = kmeans_problem(rng, b, m, n_valid)
    plusplus = k_max <= 256

    @functools.partial(jax.jit, static_argnames=())
    def jrows(p, v, k):
        return jax.vmap(
            lambda p1, v1, k1: JCL.kmeans(
                p1, v1, k1, k_max=k_max, iters=10, seed=42, chunk=min(2048, m),
                plusplus=plusplus,
            )[0]
        )(p, v, k)

    want = np.asarray(jrows(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(np.array(ks, np.int32))))
    got = TCL.kmeans_rows(
        torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
        iters=10, seed=42, plusplus=plusplus,
    ).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])


def test_kmeans_host_many_matches_jax(rng):
    problems = []
    for n, k in ((700, 40), (1500, 300), (1, 3), (50, 1)):
        pts, _ = kmeans_problem(rng, 1, n, [n])
        problems.append((pts[0], k))
    want = JCL.kmeans_host_many(problems, seed=42)
    got = TCL.kmeans_host_many(problems, torch.device("cpu"), seed=42)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [20480, 20483, 1023])
def test_cuda_slic_assign_matches_plain(cuda, rng, mp):
    """MP on and off the kernel's 4-pixels-per-thread, 1024-pixel tile."""
    b, k = 3, 256
    feats = torch.from_numpy((rng.random((b, mp, 5)) * 200).astype(np.float32)).to(cuda)
    centers = feats[:, :k].clone()
    centers[:, 200:] = 1e6
    before = TSA.launches
    got = TSA.slic_assign(feats, centers)
    assert TSA.launches == before + 1
    want = TSA.slic_assign_ref(feats, centers)
    torch.cuda.synchronize()
    assert bool((got == want).all())
    assert int(got.max()) < 200


def _cuda_eps_problem(rng, b, n):
    P = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), bool)
    groups = np.full((b, n), -1, np.int32)
    for r in range(b):
        pts = np.unique(rng.integers(0, 256, (int(rng.integers(n // 8, n)), 3)), axis=0)
        P[r, : len(pts)] = pts
        valid[r, : len(pts)] = True
        groups[r, : len(pts)] = np.arange(len(pts)) % 2
    eps2 = torch.tensor([np.float32(e) ** 2 for e in np.linspace(10, 100, b)], dtype=torch.float32)
    return torch.from_numpy(P), torch.from_numpy(valid), torch.from_numpy(groups), eps2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1000, 700, 77])
def test_cuda_eps_driver_matches_plain(cuda, rng, n):
    """N on and off the kernel's 256-column and 512-row tiles, two
    interleaved groups per row."""
    args = _cuda_eps_problem(rng, 6, n)
    want, _ = TEPS.eps_components_rows(*args, sweep=TEPS.eps_sweep_ref)
    before = TEPS.launches
    got, sweeps = TEPS.eps_components_rows(*(a.to(cuda) for a in args))
    assert TEPS.launches == before + 1 and sweeps >= 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 700])
def test_cuda_eps_sweep_matches_plain(cuda, rng, n):
    pts, valid, groups, eps2 = _cuda_eps_problem(rng, 5, n)
    lab = torch.from_numpy(rng.permutation(5 * n).reshape(5, n).astype(np.int32))
    args = (pts, lab, valid.to(torch.uint8), groups, eps2)
    want = TEPS.eps_sweep_ref(*args)
    before = TEPS.sweep_launches
    got = TEPS.eps_sweep(*(a.to(cuda) for a in args))
    assert TEPS.sweep_launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_cuda_eps_packed_matches_plain(cuda, rng):
    pts, valid, _, eps2 = _cuda_eps_problem(rng, 4, 300)
    rows = (pts[..., 0].int() | (pts[..., 1].int() << 8) | (pts[..., 2].int() << 16))
    rows = torch.where(valid, rows, torch.full_like(rows, -1)).contiguous()
    want, _ = TEPS.eps_components_packed(rows, eps2)
    got, _ = TEPS.eps_components_packed(rows.to(cuda), eps2.to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ---------------------------------------------------------------------------
# Kernel 1's expanded form, the SLIC centre sums and the torch log32 (the
# JAX package's default SLIC and k-means++ logits).
# ---------------------------------------------------------------------------

@jax.jit
def _jax_expanded_assign(rows, centers, center_valid):
    """The assign of the JAX package's default SLIC mode (ops/slic.py,
    `_slic_core`, `one_chunk`), written out as it is there."""
    c2 = jnp.sum(centers * centers, axis=1)
    d2 = (
        jnp.sum(rows * rows, axis=1, keepdims=True)
        + c2[None, :]
        - 2.0 * jax.lax.dot_general(
            rows, centers, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
        )
    )
    d2 = jnp.where(center_valid[None, :], d2, jnp.float32(3.4e38))
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("seed,k,scale,near_tie", [
    (0, 64, 100.0, False), (1, 256, 100.0, True), (2, 64, 1.0, True), (3, 64, 250.0, True),
])
def test_expanded_assign_plain_matches_xla(seed, k, scale, near_tie):
    """No tie allowance: the plain version rounds where XLA's CPU code
    rounds.  The near-tie case repeats half the centres moved by a few 1e-5;
    a quarter of the centres are not valid and must never win."""
    rng = np.random.default_rng(seed)
    mp = 16384
    feats = (rng.random((mp, 5)) * scale).astype(np.float32)
    centers = (rng.random((k, 5)) * scale).astype(np.float32)
    if near_tie:
        centers[k // 2:] = centers[: k - k // 2] + rng.integers(-2, 3, (k - k // 2, 5)).astype(
            np.float32) * np.float32(1e-5)
    valid = np.ones(k, bool)
    valid[rng.choice(k, k // 4, replace=False)] = False
    want = np.asarray(_jax_expanded_assign(feats, centers, valid))
    got = TSA.slic_assign_expanded(
        torch.from_numpy(feats)[None], torch.from_numpy(centers)[None], torch.from_numpy(valid)[None]
    )[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert valid[got].all()


@pytest.mark.usefixtures("one_thread")
def test_expanded_assign_checks_its_arguments():
    f, c = torch.zeros((1, 64, 5)), torch.zeros((1, 4, 5))
    with pytest.raises(ValueError, match="center_valid"):
        TSA.slic_assign_expanded(f, c, torch.ones((1, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="center_valid"):
        TSA.slic_assign_expanded(f, c, torch.ones((1, 4), dtype=torch.uint8))


@functools.partial(jax.jit, static_argnames=("chunk", "k"))
def _jax_centre_sums(feats, valid, ids, chunk, k):
    """The JAX package's SLIC centre sums (ops/slic.py, `_update`), vmapped
    as its bucket calls are."""
    def one(f, v, i):
        kids = jnp.arange(k)[None, :]

        def upd_chunk(sums, start):
            rows = jax.lax.dynamic_slice_in_dim(f, start, chunk)
            ch = jax.lax.dynamic_slice_in_dim(i, start, chunk)
            vv = jax.lax.dynamic_slice_in_dim(v, start, chunk)
            oh = ((ch[:, None] == kids) & vv[:, None]).astype(jnp.float32)
            return sums + jax.lax.dot_general(
                oh, rows, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST), None

        sums, _ = jax.lax.scan(upd_chunk, jnp.zeros((k, 5), jnp.float32), jnp.arange(0, f.shape[0], chunk))
        return sums

    return jax.vmap(one)(feats, valid, ids)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("m,chunk,k", [
    (4096, 2048, 64), (32768, 2048, 256), (4096, 4096, 64), (8192, 8192, 256), (16384, 16384, 64),
    (40960, 16384, 64),
])
def test_centre_sums_match_xla_update(m, chunk, k):
    """The SLIC centre sums in the order of the JAX package's CPU run, bit for
    bit: chunks of 2048 (the Pallas mode) and of min(16384, m) (the default).
    The order is that of an 8-thread host, which this project's hosts are."""
    rng = np.random.default_rng(m + k)
    feats = np.zeros((2, m, 5), np.float32)
    feats[..., 0] = rng.uniform(0, 100, (2, m))
    feats[..., 1:3] = rng.uniform(-60, 60, (2, m, 2))
    feats[..., 3:] = rng.uniform(0, 120, (2, m, 2))
    ids = rng.integers(0, k, (2, m)).astype(np.int32)
    valid = rng.random((2, m)) < 0.9
    span = -(-m // chunk) * chunk
    pad = lambda a: np.concatenate([a, np.zeros((2, span - m) + a.shape[2:], a.dtype)], 1)  # noqa: E731
    want = np.asarray(_jax_centre_sums(pad(feats), pad(valid), pad(ids), chunk, k))
    got = TSLIC._centre_sums(torch.from_numpy(ids), torch.from_numpy(feats), torch.from_numpy(valid),
                             m, chunk, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # The card's form of the block sums (one launch per pixel position) adds
    # in the same order as the CPU's numpy form.
    x = torch.from_numpy(feats[0, :2048].reshape(8, 256, 5))
    rows = torch.arange(8)[:, None] * k + torch.from_numpy(ids[0, :2048].reshape(8, 256)).long()
    assert torch.equal(TSLIC._block_sums(x, rows, 8 * k), TSLIC._block_sums(x, rows, 8 * k, loop=True))


@pytest.mark.usefixtures("one_thread")
def test_log32_torch_is_xla_log():
    """>= 10^6 floats: uniforms, squared colour distances, and distances a
    few ulps apart (the k-means++ logits)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(600_000).astype(np.float32),
        (rng.integers(0, 256, (300_000, 3)).astype(np.float32) ** 2).sum(1),
        np.float32(1234.5) * (1 + rng.integers(-64, 64, 150_000) * np.float32(2.0**-23)),
    ]).astype(np.float32) + np.float32(1e-20)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = prng.log32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(prng.log32(x).view(np.int32), want.view(np.int32))
