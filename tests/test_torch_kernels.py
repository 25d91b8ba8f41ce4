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
from roibasedimagecompression_torch.ops.cuda import epscc as TEPS
from roibasedimagecompression_torch.ops.cuda import slic_assign as TSA


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_ids_equal_or_tied(got, want, feats, centers):
    """Equal ids, except where both ids are at the minimal distance (the
    Pallas interpret run contracts d2 + diff*diff into fused multiply-adds;
    the kernel and its plain version round every step)."""
    diff = got != want
    assert diff.mean() < 1e-3, diff.mean()
    if diff.any():
        d2 = ((feats[:, None, :].astype(np.float64) - centers[None, :, :]) ** 2).sum(-1)
        rows = np.flatnonzero(diff)
        np.testing.assert_allclose(d2[rows, got[rows]], d2[rows, want[rows]], rtol=1e-6)


def test_slic_assign_plain_matches_pallas(rng):
    mp, k = 4096, 64
    feats = rng.random((mp, 5)).astype(np.float32) * 100.0
    centers = rng.random((k, 5)).astype(np.float32) * 100.0
    want = np.asarray(JSA.slic_assign_pallas(jnp.asarray(feats), jnp.asarray(centers), interpret=True))
    got = TSA.slic_assign(torch.from_numpy(feats)[None], torch.from_numpy(centers)[None])[0].numpy()
    _assert_ids_equal_or_tied(got, want, feats, centers)


def test_slic_assign_plain_sentinel(rng):
    feats = rng.random((2, 2048, 5)).astype(np.float32)
    centers = np.full((2, 8, 5), 1e6, np.float32)
    centers[:, :3] = rng.random((2, 3, 5)).astype(np.float32)
    got = TSA.slic_assign(torch.from_numpy(feats), torch.from_numpy(centers)).numpy()
    assert got.max() < 3
    for b in range(2):
        want = np.asarray(JSA.slic_assign_pallas(jnp.asarray(feats[b]), jnp.asarray(centers[b]), interpret=True))
        _assert_ids_equal_or_tied(got[b], want, feats[b], centers[b])


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


def _kmeans_problem(rng, b, m, n_valid):
    centers = rng.integers(0, 256, (b, 9, 3))
    pick = rng.integers(0, 9, (b, m))
    pts = np.clip(
        np.take_along_axis(centers, pick[..., None].repeat(3, -1), 1)
        + rng.integers(-30, 31, (b, m, 3)), 0, 255,
    ).astype(np.float32)
    valid = np.arange(m)[None, :] < np.asarray(n_valid)[:, None]
    pts[~valid] = 0.0
    return pts, valid


@pytest.mark.parametrize("ks,k_max,m", [((5, 17, 2), 32, 1024), ((300, 280, 400), 512, 2048)])
def test_kmeans_rows_match_jax(rng, ks, k_max, m):
    b = len(ks)
    n_valid = [m, m - 100, m // 2]
    pts, valid = _kmeans_problem(rng, b, m, n_valid)
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
        pts, _ = _kmeans_problem(rng, 1, n, [n])
        problems.append((pts[0], k))
    want = JCL.kmeans_host_many(problems, seed=42)
    got = TCL.kmeans_host_many(problems, torch.device("cpu"), seed=42)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_slic_assign_matches_plain(cuda, rng):
    b, mp, k = 3, 20480, 256
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


@pytest.mark.cuda
def test_cuda_eps_driver_matches_plain(cuda, rng):
    b, n = 6, 1024
    P = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), bool)
    for r in range(b):
        pts = np.unique(rng.integers(0, 256, (int(rng.integers(100, n)), 3)), axis=0)
        P[r, : len(pts)] = pts
        valid[r, : len(pts)] = True
    groups = torch.zeros((b, n), dtype=torch.int32)
    eps2 = torch.tensor([np.float32(e) ** 2 for e in (10, 20, 40, 60, 80, 100)])
    args = (torch.from_numpy(P), torch.from_numpy(valid), groups, eps2)
    want, _ = TEPS.eps_components_rows(*args, sweep=TEPS.eps_sweep_ref)
    got, _ = TEPS.eps_components_rows(*(a.to(cuda) for a in args))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
