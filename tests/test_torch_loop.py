"""PyTorch port, the reference-shaped encode loop (`CodecConfig(batched=False)`)
at `single_region=True`: k-means and eps components of one palette, palette
clustering and the canvas merges of the three tiers, one-region SLIC and
segment counts, and the loop's bytes, each against the JAX package on the
same synthetic images (the ROI frontend of the loop: test_torch_roi.py)."""

import os

import jax
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import quantize as JQ
from roibasedimagecompression_tpu.models import segment as JSEG
from roibasedimagecompression_tpu.ops import cluster as JCL
from roibasedimagecompression_tpu.ops import slic as JSLIC
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import quantize as TQ
from roibasedimagecompression_torch.models import segment as TSEG
from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.ops import metrics as TM
from roibasedimagecompression_torch.ops import slic as TSLIC
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's torch work on one thread: the suite runs several worker
    processes on the host's cores, and torch's spinning pool threads slow
    the JAX package's compiles and runs in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SINGLE = dict(batched=False, single_region=True)
SEEDS = (100, 3, 7)


@pytest.fixture(scope="module")
def slic_mode(request):
    """RHCCQ_SLIC_PALLAS for both packages; the JAX package reads it at trace
    time, so its caches are dropped when it is set and when it is restored."""
    old = os.environ.pop("RHCCQ_SLIC_PALLAS", None)
    if request.param is not None:
        os.environ["RHCCQ_SLIC_PALLAS"] = request.param
    jax.clear_caches()
    yield request.param
    os.environ.pop("RHCCQ_SLIC_PALLAS", None)
    if old is not None:
        os.environ["RHCCQ_SLIC_PALLAS"] = old
    jax.clear_caches()


def _noisy(seed, h=128, w=160, sigma=14.0):
    img = synthetic_image(seed, h, w).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, sigma, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _palette(seed, n):
    """n distinct colours of a noisy synthetic image, in a seeded order."""
    pal = np.unique(_noisy(seed, 128, 160, 24.0).reshape(-1, 3), axis=0)
    rng = np.random.default_rng(seed)
    return pal[rng.permutation(len(pal))[:n]]


@pytest.mark.parametrize("n,k", [(700, 12), (3000, 300)], ids=["plusplus", "random-init"])
def test_kmeans_host_matches_jax(n, k):
    pts = _palette(31, n).astype(np.float32)
    want = np.asarray(JCL.kmeans_host(pts, k, seed=42))
    got = TCL.kmeans_host(pts, k, CPU, seed=42)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_eps_components_host_matches_jax(route, monkeypatch):
    """Both routes of the JAX package's eps_components_host (its XLA sweep,
    and its Pallas kernel in interpret mode under RHCCQ_USE_PALLAS=1, read
    per call), with and without groups."""
    monkeypatch.setenv("RHCCQ_USE_PALLAS", "1" if route == "pallas" else "0")
    pts = _palette(32, 300 if route == "pallas" else 1500).astype(np.float32)
    groups = (np.arange(len(pts)) % 3).astype(np.int32)
    for eps in (9.0, 17.5):
        for g in (None, groups):
            want = np.asarray(JCL.eps_components_host(pts, eps, g))
            got = TCL.eps_components_host(pts, eps, CPU, g)
            np.testing.assert_array_equal(got, want)
    assert TCL.eps_components_host(np.zeros((0, 3), np.float32), 9.0, CPU).shape == (0,)


@pytest.mark.parametrize(
    "n,quality,env",
    [(40, 20.0, {}), (2500, 20.0, {}), (2500, 10.0, {"RHCCQ_SPLIT_METHOD": "hybrid"}),
     (10_400, 40.0, {})],
    ids=["small", "eps+kmeans-split", "hybrid-override", "kmeans-switch"],
)
def test_cluster_palette_matches_jax(n, quality, env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if n > 5000:
        rng = np.random.default_rng(33)
        pal = np.unique(rng.integers(0, 256, (2 * n, 3)).astype(np.uint8), axis=0)[:n]
    else:
        pal = _palette(33, n)
    pal[: max(1, n // 50)] = 0  # black rows stay black and come first
    weights = np.random.default_rng(1).integers(1, 50, len(pal)).astype(np.float64)
    for w in (None, weights) if n < 5000 else (weights,):
        jp, jm = JQ.cluster_palette(pal, quality, seed=42, weights=w)
        tp, tm = TQ.cluster_palette(pal, quality, CPU, seed=42, weights=w)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tm, jm)


def _regions(img):
    h, w = img.shape[:2]
    return [JSEG.Region(bbox=(0, 0, h, w), bbox_mask=np.ones((h, w), bool), area=h * w, kind="roi")]


def _same_components(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.top_left) == tuple(y.top_left)
        np.testing.assert_array_equal(x.palette, y.palette)
        np.testing.assert_array_equal(x.indices, y.indices)


def test_tiers_match_jax():
    """Tier 1 (subregion_quantization: SLIC, black repair, per-segment
    clustering, merge_components), tier 2 (region_quantization) and tier 3
    (quantize_image) on a whole-image region."""
    img = _noisy(34, 64, 96, 12.0)
    img[:20, :30] = 0  # black pixels inside segments take the repair
    h, w = img.shape[:2]
    jconfig = jcfg.CodecConfig(**SINGLE)
    tconfig = tcfg.CodecConfig(**SINGLE)
    jt1 = JCODEC.subregion_quantization(img, _regions(img), 20.0, jconfig)
    tt1 = TCODEC.subregion_quantization(img, _regions(img), 20.0, tconfig, CPU)
    _same_components(tt1, jt1)
    jt2 = JQ.region_quantization(jt1, h, w, 40.0, seed=42)
    tt2 = TQ.region_quantization(tt1, h, w, 40.0, CPU, seed=42)
    _same_components([tt2], [jt2])
    _same_components([TQ.quantize_image([tt2], h, w, 60.0, CPU, seed=42)],
                     [JQ.quantize_image([jt2], h, w, 60.0, seed=42)])
    # Overlapping components: the first listed wins, black never writes.
    jm = JQ.merge_components([jt2, jt1[0]], (10, 20, h, w))
    tm = TQ.merge_components([tt2, tt1[0]], (10, 20, h, w))
    _same_components([tm], [jm])


def test_black_repair_matches_jax():
    px = np.array([[0, 0, 0], [5, 9, 1], [3, 3, 3], [0, 0, 0], [200, 1, 1]], np.uint8)
    np.testing.assert_array_equal(TCODEC._black_repair(px), JCODEC._black_repair(px))
    black = np.zeros((4, 3), np.uint8)
    np.testing.assert_array_equal(TCODEC._black_repair(black), JCODEC._black_repair(black))


def test_hierarchical_palette_clustering_matches_jax():
    pal = _palette(35, 400)
    idx = np.random.default_rng(2).integers(0, len(pal), (24, 32))
    jp, ji = JQ.hierarchical_palette_clustering(pal, idx, 30.0, seed=42)
    tp, ti = TQ.hierarchical_palette_clustering(pal, idx, CPU, 30.0, seed=42)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)


def test_slic_one_region_matches_jax():
    img = synthetic_image(36, 96, 128)
    mask = np.zeros((96, 128), bool)
    mask[8:90, 4:120] = True
    mask[40:60, 50:70] = False
    for n in (12, 40):
        np.testing.assert_array_equal(TSLIC.slic(img, mask, n, CPU), JSLIC.slic(img, mask, n))


def _loop_regions(seed):
    """Every region the loop fixtures take into SLIC: the whole image, and
    the ROI and non-ROI regions of its ROI masks."""
    from roibasedimagecompression_tpu.models import roi as JROI

    img = synthetic_image(seed, 128, 160)
    out = [(img, np.ones(img.shape[:2], bool))]
    config = jcfg.CodecConfig(batched=False)
    roi, nonroi = JROI.roi_masks(img, config)
    regs = JCODEC._extract_and_assign(img, roi, nonroi, config, jcfg.min_region_size(img.size))
    for r in regs[0] + regs[1]:
        minr, minc, maxr, maxc = r.bbox
        out.append((img[minr:maxr, minc:maxc], r.bbox_mask))
    return out


@pytest.mark.parametrize("seed", [100, 7, 12])
def test_optimal_segments_match_jax_one_region(seed):
    """Segment counts of the one-image call at B = 1 (the loop's), which the
    batched tests never use: equal counts, and scores bit for bit."""
    for crop, mask in _loop_regions(seed):
        assert TSEG.optimal_segments(crop, mask, CPU) == JSEG.optimal_segments(crop, mask)
        np.testing.assert_array_equal(TSEG.split_score(crop, mask, CPU),
                                      JSEG.split_score(crop, mask))
        n = JSEG.optimal_segments(crop, mask)
        np.testing.assert_array_equal(TSEG.region_segments(crop, mask, n, CPU),
                                      JSEG.region_segments(crop, mask, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_loop_single_region_bytes_match_jax(seed):
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(seed, 128, 160)
    ours = rtt.encode(img, tcfg.CodecConfig(**SINGLE), device="cpu")
    assert ours == rtc.encode(img, jcfg.CodecConfig(**SINGLE))
    np.testing.assert_array_equal(rtt.decode(ours), rtc.decode(ours))


@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, ids=["pallas"])
def test_loop_single_region_bytes_match_jax_direct_slic(slic_mode):
    """Kernel 1's direct form (RHCCQ_SLIC_PALLAS=1) on the loop, on one of
    the fixtures above (the other mode)."""
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(SEEDS[-1], 128, 160)
    assert rtt.encode(img, tcfg.CodecConfig(**SINGLE), device="cpu") == \
        rtc.encode(img, jcfg.CodecConfig(**SINGLE))


def test_loop_and_batched_paths_agree_in_quality():
    """The JAX package's law of the two paths (tests/test_codec.py): the
    batched tier 1 and the per-segment loop land within 2 dB and 35 % in
    size of each other."""
    for seed in (100, 38):
        img = synthetic_image(seed, 80, 80)
        a = rtt.encode(img, tcfg.CodecConfig(single_region=True, batched=True), device="cpu")
        b = rtt.encode(img, tcfg.CodecConfig(**SINGLE), device="cpu")
        qa = TM.quality_metrics(img, rtt.decode(a), device="cpu")
        qb = TM.quality_metrics(img, rtt.decode(b), device="cpu")
        assert abs(qa["psnr"] - qb["psnr"]) < 2.0
        assert abs(len(a) - len(b)) / max(len(a), len(b)) < 0.35


@pytest.mark.cuda
def test_cuda_loop_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from roibasedimagecompression_torch.ops.cuda import _build

    img = _noisy(39, 256, 320, 10.0)
    for config in (tcfg.CodecConfig(**SINGLE), tcfg.CodecConfig(batched=False)):
        s0, e0 = _build.launched["slic_assign"].total(), _build.launched["epscc"].total()
        gpu = rtt.encode(img, config)
        assert _build.launched["slic_assign"].total() > s0 and _build.launched["epscc"].total() > e0
        assert gpu == rtt.encode(img, config, device="cpu")
