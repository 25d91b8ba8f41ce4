"""PyTorch port, region fusion and the weighted split (ROADMAP A12c): the
region passes, weighted k-means (its draws, its centre sums in XLA's CPU
order), the tier-1 table, RHCCQ_WEIGHTED_SPLIT and its one-time warning,
and the bytes of every entry point, each against the JAX package on the
same seeded inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
import roibasedimagecompression_tpu as rtc
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.models import segment as JSEG
from roibasedimagecompression_tpu.ops import cluster as JCL
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.models import segment as TSEG
from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

from kmeans_cases import WEIGHTED_ROWS_CASES, weighted_problem


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's torch work on one thread: the suite runs several worker
    processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed, h=96, w=128, n=40):
    """A mask of random rectangles: touching, overlapping and lone regions
    of many sizes, around the fusion path's minimum size."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    for _ in range(n):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y : y + rng.integers(1, 12), x : x + rng.integers(1, 12)] = True
    return m


def _same_regions(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.bbox, a.area, a.kind) == (b.bbox, b.area, b.kind)
        np.testing.assert_array_equal(a.bbox_mask, b.bbox_mask)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_region_fusion_passes_match_jax(seed):
    """fuse_adjacent_regions and process_regions_with_reassignment, on masks
    whose small regions move both ways and whose regions touch."""
    img = synthetic_image(seed, 96, 128)
    roi = _blobs(seed)
    nonroi = ~roi | _blobs(seed + 50)
    fused = TSEG.process_regions_with_reassignment(img, roi, nonroi)
    for ours, theirs in zip(fused, JSEG.process_regions_with_reassignment(img, roi, nonroi)):
        _same_regions(ours, theirs)
    # Small regions moved kinds and touching ones fused.
    plain = TSEG.reassign_small_roi(TSEG.extract_regions(roi, "roi"),
                                    TSEG.extract_regions(nonroi, "nonroi"), 0)
    assert [len(rs) for rs in fused] != [len(rs) for rs in plain]
    regions = TSEG.extract_regions(roi, "roi")
    jregions = JSEG.extract_regions(roi, "roi")
    assert len(regions) > 2
    # Spread the regions apart and back: neighbours fuse, lone ones stay.
    _same_regions(TSEG.fuse_adjacent_regions(regions, img.shape, "roi"),
                  JSEG.fuse_adjacent_regions(jregions, img.shape, "roi"))
    shifted = [dataclasses.replace(r, kind="nonroi") for r in regions]
    _same_regions(TSEG.fuse_adjacent_regions(shifted, img.shape, "nonroi"),
                  JSEG.fuse_adjacent_regions(
                      [dataclasses.replace(r, kind="nonroi") for r in jregions], img.shape, "nonroi"))


@pytest.mark.parametrize("ks,k_max,m,w_max", WEIGHTED_ROWS_CASES)
def test_weighted_kmeans_rows_match_jax(ks, k_max, m, w_max):
    """Weighted k-means (++ draws in proportion to w * d^2 with XLA's fused
    `d2 * w + 1e-20`, weighted centre sums in XLA's order) equals the JAX
    kernel's labels on every valid point."""
    rng = np.random.default_rng(m + len(ks))
    b = len(ks)
    pts, valid, w = weighted_problem(rng, b, m, [m, m - 10, m // 2], w_max)

    @jax.jit
    def jrows(p, v, k, wt):
        return jax.vmap(
            lambda p1, v1, k1, w1: JCL.kmeans(
                p1, v1, k1, k_max=k_max, iters=10, seed=42, chunk=min(2048, m),
                plusplus=True, weights=w1,
            )[0]
        )(p, v, k, wt)

    want = np.asarray(jrows(jnp.asarray(pts), jnp.asarray(valid),
                            jnp.asarray(np.array(ks, np.int32)), jnp.asarray(w)))
    got = TCL.kmeans_rows(
        torch.from_numpy(pts), torch.from_numpy(valid), np.array(ks), k_max=k_max,
        iters=10, seed=42, plusplus=True, weights=torch.from_numpy(w),
    ).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.parametrize("ks,k_max,m,w_max", [
    ((3, 5, 4), 16, 1024, 723),               # sequential: 256-point spans, added in turn
    ((40, 70, 100), 128, 1024, 20_000),       # sharded over 8 threads: 128-point spans
    ((100, 200, 150), 256, 512, 40_000),      # sharded: 96-point spans, a short last one
    ((5, 9, 2), 16, 4096, (2000, 0.005)),     # products beyond 2^24, two 2048-point chunks
    ((100, 200, 150), 256, 2048, (2000, 0.005)),  # 8 spans of 256, products beyond 2^24
    ((3, 2, 2), 2, 1024, (2000, 0.01)),       # K = 2: one chain over the chunk
])
def test_weighted_centre_sums_match_jax(ks, k_max, m, w_max):
    """The weighted centre sums (ops/cluster.py `_weighted_sums`) bit for bit:
    one Lloyd step of the JAX kmeans from given centres, its new centres
    against the port's sums over the JAX labels divided by the pixel counts
    (exact integers), on every centre that holds a point.  The rows' sums
    pass 2^24, so only XLA's order gives these bits (ROADMAP §C11)."""
    rng = np.random.default_rng(m + k_max)
    b = len(ks)
    pts, valid, w = weighted_problem(rng, b, m, [m, m - 10, m // 2], w_max)
    init = pts[:, rng.integers(0, m // 2, k_max)].copy()

    def step(iters):
        run = jax.jit(jax.vmap(lambda p1, v1, k1, w1, c1: JCL.kmeans(
            p1, v1, k1, k_max=k_max, iters=iters, seed=42, chunk=min(2048, m),
            plusplus=False, init_centers=c1, weights=w1)))
        labels, centers = run(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(np.array(ks, np.int32)),
                              jnp.asarray(w), jnp.asarray(init))
        return np.asarray(labels), np.asarray(centers)

    labels = np.where(valid, step(0)[0], 0)
    want = step(1)[1]
    counts = np.zeros((b, k_max), np.float64)
    for i in range(b):
        np.add.at(counts[i], labels[i], w[i])
    sums = TCL._weighted_sums(torch.from_numpy(labels), torch.from_numpy(w), torch.from_numpy(pts),
                              torch.from_numpy(valid), k_max).numpy()
    assert sums.max() > 2**24 > w.sum(axis=1).max()
    got = sums / np.maximum(counts, 1.0).astype(np.float32)[..., None]
    live = counts > 0
    np.testing.assert_array_equal(got.view(np.uint32)[live], want.view(np.uint32)[live])


def test_fma_tiny_rounds_halfway_products_up():
    """XLA contracts `d2 * w + 1e-20`: a product halfway between two floats
    rounds up, not to even (4097^2 = 2^24 + 2^13 + 1)."""
    a = torch.tensor([4097.0, 3.0, 0.0])
    got = TCL._fma_tiny(a, a, 1e-20).numpy()
    want = np.asarray(jax.jit(lambda x: x * x + 1e-20)(jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == 16785410.0


def _split_image(seed=31, h=96, w=128):
    img = synthetic_image(seed, h, w).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, 14.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def split_case():
    """A noisy image's segment map (its clusters split by k-means) and the
    JAX package's weighted tier-1 table of it."""
    img = _split_image()
    config = jcfg.CodecConfig(split_method="kmeans")
    whole = JSEG.Region((0, 0) + img.shape[:2], np.ones(img.shape[:2], bool),
                        img.shape[0] * img.shape[1], "roi")
    seg_map, seg_q, _ = JCODEC.build_segment_map(img, [whole], [], config)
    want = JQB.tier1_table(img, seg_map, seg_q, seed=42, split_method="kmeans",
                           weighted_split=True)
    return img, seg_map, seg_q, want


def test_tier1_table_weighted_split_matches_jax(split_case):
    img, seg_map, seg_q, want = split_case
    got = TQB.tier1_table(img, seg_map, seg_q, torch.device("cpu"), seed=42,
                          split_method="kmeans", weighted_split=True)
    np.testing.assert_array_equal(got["cluster_of_pair"], want["cluster_of_pair"])
    np.testing.assert_array_equal(got["cluster_colors"], want["cluster_colors"])
    plain = TQB.tier1_table(img, seg_map, seg_q, torch.device("cpu"), seed=42, split_method="kmeans")
    assert not np.array_equal(plain["cluster_colors"], got["cluster_colors"])


def test_weighted_split_warns_once_per_reason(monkeypatch, split_case):
    """The paths without a weighted form warn once per reason and process,
    as the JAX package's do; the median cuts are one."""
    img, seg_map, seg_q, _ = split_case
    monkeypatch.setattr(TQB, "_WEIGHT_DROP_WARNED", set())
    monkeypatch.setenv("RHCCQ_WEIGHTED_SPLIT", "1")
    with pytest.warns(RuntimeWarning, match="split_method='mediancut'"):
        TQB.tier1_table(img, seg_map, seg_q, torch.device("cpu"), split_method="mediancut")
    assert TQB._WEIGHT_DROP_WARNED == {"split_method='mediancut'"}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TQB.tier1_table(img, seg_map, seg_q, torch.device("cpu"), split_method="mediancut")
    assert TQB._weighted_split_on(False) and TQB._weighted_split_on(True)
    monkeypatch.setenv("RHCCQ_WEIGHTED_SPLIT", "0")
    assert not TQB._weighted_split_on(True)
    monkeypatch.delenv("RHCCQ_WEIGHTED_SPLIT")
    assert TQB._weighted_split_on(True) and not TQB._weighted_split_on(False)


@pytest.mark.parametrize("kw", [
    dict(region_fusion=True),
    dict(weighted_split=True, split_method="kmeans"),
    dict(region_fusion=True, batched=False),
], ids=["fusion", "weighted", "fusion-loop"])
@pytest.mark.parametrize("seed", [12])
def test_option_bytes_match_jax(kw, seed):
    """`encode` at region_fusion=True (both paths) and weighted_split=True
    writes the JAX package's bytes."""
    img = synthetic_image(seed, 96, 128) if "weighted_split" not in kw else _split_image(seed)
    assert rtt.encode(img, tcfg.CodecConfig(**kw), device="cpu") == rtc.encode(
        img, jcfg.CodecConfig(**kw))


@pytest.mark.parametrize("kw", [dict(region_fusion=True),
                                dict(weighted_split=True, split_method="kmeans")],
                         ids=["fusion", "weighted"])
def test_option_bytes_encode_many_match_jax(kw):
    imgs = [synthetic_image(7, 96, 128), _split_image(12)]
    got = TSTREAM.encode_many(imgs, tcfg.CodecConfig(**kw), device="cpu")
    assert got == JSTREAM.encode_many(imgs, jcfg.CodecConfig(**kw))
