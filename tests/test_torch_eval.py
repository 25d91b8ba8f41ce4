"""PyTorch port, evaluation surface and the encode options of the CLI, each
held against the JAX function on the same numpy input, on the CPU:

- SSIM: the mean (eager `ssim` and jitted `quality_metrics`) and every
  pixel of the map bit for bit (XLA's CPU convolution, reductions and
  fused multiply-adds, ops/metrics.py); every value of `quality_metrics`
  bit for bit;
- harness, adaptive metrics and report: strings and integers exact, numpy
  floats exact, the float32 device means (PSNR, MSE, MAE) within 1e-6
  relative (an ulp or two; a standard deviation over them within 1e-5),
  SSIM-derived values exact;
- JPEG search: quality and bytes exact;
- CLAHE: exact uint8; the cv2 Lab conversions: one unit on a few inputs
  (XLA's `pow` is glibc's powf, not correctly rounded; see ops/colors.py),
  the enhancer exact on the fixtures;
- the mediancut and kmeans-mc splits: tier-1 tables exact, and the
  max-colours law;
- XLA's float32 log (the Gumbel noise): bit-exact on 10^6 inputs.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.eval import adaptive as JA
from roibasedimagecompression_tpu.eval import harness as JH
from roibasedimagecompression_tpu.eval import report as JR
from roibasedimagecompression_tpu.io import container as JC
from roibasedimagecompression_tpu.io import image_io as JIO
from roibasedimagecompression_tpu.models import enhance as JE
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.ops import clahe as JCL
from roibasedimagecompression_tpu.ops import colors as JCOL
from roibasedimagecompression_tpu.ops import metrics as JM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.eval import adaptive as TA
from roibasedimagecompression_torch.eval import harness as TH
from roibasedimagecompression_torch.eval import report as TR
from roibasedimagecompression_torch.io import container as TC
from roibasedimagecompression_torch.io import image_io as TIO
from roibasedimagecompression_torch.models import enhance as TE
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.ops import clahe as TCL
from roibasedimagecompression_torch.ops import cluster as TCLU
from roibasedimagecompression_torch.ops import colors as TCOL
from roibasedimagecompression_torch.ops import metrics as TM
from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test's torch work on one thread and restores the count
    after: the suite runs several worker processes on the host's cores, and
    a torch thread pool per worker only adds contention to these tests (the
    metrics' float32 orders are many small steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _degraded(seed, h=128, w=160):
    """An original and a reconstruction: noise on even seeds, a coarse
    palette on odd ones."""
    a = synthetic_image(seed, h, w)
    if seed % 2:
        return a, (a // 32) * 32
    noise = np.random.default_rng(seed).integers(-20, 21, a.shape)
    return a, np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)


def _close(ours, theirs, path=""):
    """Strings and integers exact, floats within 1e-6 relative (standard
    deviations within 1e-5), SSIM-derived values exact."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _close(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(theirs, (float, np.floating)):
        if "ssim" in path:
            assert float(ours) == float(theirs), path
            return
        tol = dict(rel=1e-6, abs=1e-6)
        if path.endswith("_std"):
            tol = dict(abs=1e-5)
        assert float(ours) == pytest.approx(float(theirs), **tol), path
    else:
        assert ours == theirs, path


@pytest.mark.parametrize("seed,h,w", [(0, 128, 160), (1, 128, 160), (2, 96, 200), (3, 512, 768)])
def test_ssim_and_ssim_map_match_jax(seed, h, w):
    a, b = _degraded(seed, h, w)
    jm = float(JM.ssim(jnp.asarray(a), jnp.asarray(b)))
    tm = float(TM.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert tm == jm
    assert TM.quality_metrics(a, b, CPU) == JM.quality_metrics(a, b)  # every value, bit for bit
    gray = float(TM.ssim(torch.from_numpy(a[..., 1]), torch.from_numpy(b[..., 1])))
    assert gray == float(JM.ssim(jnp.asarray(a[..., 1]), jnp.asarray(b[..., 1])))
    jmap, tmap = JM.ssim_map(a, b), TM.ssim_map(a, b, device=CPU)
    assert tmap.shape == jmap.shape == (h, w) and tmap.dtype == jmap.dtype
    np.testing.assert_array_equal(tmap.view(np.uint32), jmap.view(np.uint32))
    gray_j, gray_t = JM.ssim_map(a[..., 0], b[..., 0]), TM.ssim_map(a[..., 0], b[..., 0], device=CPU)
    np.testing.assert_array_equal(gray_t.view(np.uint32), gray_j.view(np.uint32))


def test_log32_is_xla_log():
    u = prng.uniform(prng.prng_key(3), (1_000_000,), np.finfo(np.float32).tiny, 1.0)
    np.testing.assert_array_equal(prng.log32(u), np.asarray(jax.jit(jnp.log)(u)))
    wide = np.random.default_rng(0).integers(0x00800000, 0x7F000000, 200_000, dtype=np.uint32).view(np.float32)
    np.testing.assert_array_equal(prng.log32(wide), np.asarray(jax.jit(jnp.log)(wide)))
    assert prng.log32(np.array([0.0], np.float32))[0] == -np.inf


def _pair_files(tmp_path, seeds=(11, 12)):
    """PNG originals and `.rhccq` files written from a coarse palette of each
    (a container the JAX package writes too)."""
    import roibasedimagecompression_torch as rtt

    pairs = []
    for i, seed in enumerate(seeds, start=1):
        img = synthetic_image(seed, 128, 160)
        png = tmp_path / f"{i}.png"
        JIO.imwrite(png, img)
        rq = tmp_path / f"{i}.rhccq"
        rq.write_bytes(rtt.encode(img, device=CPU))
        pairs.append((str(png), str(rq), str(i)))
    return pairs


def test_harness_matches_jax(tmp_path):
    pairs = _pair_files(tmp_path)
    ours, theirs = TH.evaluate_pairs(pairs, CPU), JH.evaluate_pairs(pairs)
    for o, t in zip(ours, theirs):
        _close(o.as_dict(), t.as_dict())
        assert o.psnr > 28.0
    _close(TH.summarize(ours), JH.summarize(theirs))
    assert TH.summarize([]) == JH.summarize([]) == {}
    TH.to_csv(ours, tmp_path / "t.csv")
    JH.to_csv(theirs, tmp_path / "j.csv")
    rows_t = list(csv.DictReader(open(tmp_path / "t.csv")))
    rows_j = list(csv.DictReader(open(tmp_path / "j.csv")))
    assert [list(r) for r in rows_t] == [list(r) for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        _close({k: float(v) if k != "name" else v for k, v in rt.items()},
               {k: float(v) if k != "name" else v for k, v in rj.items()})


def test_container_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    idx = rng.integers(0, 300, (40, 50)).astype(np.uint16)
    assert TC.save(pal, idx, tmp_path / "t.rhccq") == JC.save(pal, idx, tmp_path / "j.rhccq")
    assert (tmp_path / "t.rhccq").read_bytes() == (tmp_path / "j.rhccq").read_bytes()
    np.testing.assert_array_equal(TC.load(tmp_path / "j.rhccq").to_rgb(), JC.load(tmp_path / "j.rhccq").to_rgb())
    data = (tmp_path / "j.rhccq").read_bytes()
    assert TC.describe(data) == JC.describe(data)


@pytest.mark.parametrize("target", [1500, 4000, 9000])
def test_jpeg_at_matched_size_matches_jax(target):
    img = synthetic_image(13, 128, 160)
    t_rgb, t_data, t_q = TH.jpeg_at_matched_size(img, target)
    j_rgb, j_data, j_q = JH.jpeg_at_matched_size(img, target)
    assert t_q == j_q and t_data == j_data
    np.testing.assert_array_equal(t_rgb, j_rgb)
    assert TIO.jpeg_bytes(img, 70) == JIO.jpeg_bytes(img, 70)
    np.testing.assert_array_equal(TIO.decode_jpeg(t_data), JIO.decode_jpeg(t_data))


def test_compare_vs_jpeg_matches_jax(tmp_path):
    (png, rq, _), = _pair_files(tmp_path, seeds=(14,))
    _close(TH.compare_vs_jpeg(png, rq, CPU), JH.compare_vs_jpeg(png, rq))


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_adaptive_metrics_match_jax(seed):
    a, b = _degraded(seed)
    if seed == 4:  # a few gross outliers, so an outlier detector keeps them out
        b = b.copy()
        b[::17, ::13] = 255 - b[::17, ::13]
    ours, theirs = TA.adaptive_quality_metrics(a, b, CPU), JA.adaptive_quality_metrics(a, b)
    _close(ours, theirs)
    # The report prints SSIM to 4 decimals, everything else from numpy.
    assert TA.format_adaptive_report(ours, a.shape).splitlines()[:-4] == \
        JA.format_adaptive_report(theirs, a.shape).splitlines()[:-4]


def test_report_functions_match_jax(tmp_path):
    pairs = _pair_files(tmp_path)
    root = tmp_path / "root"
    (root / "png").mkdir(parents=True)
    (root / "rhccq_20_10").mkdir()
    for png, rq, i in pairs:
        (root / "png" / f"{i}.png").write_bytes(open(png, "rb").read())
        (root / "rhccq_20_10" / f"compressed_{i}.rhccq").write_bytes(open(rq, "rb").read())
    ours = TR.run_batch_evaluation(root, csv_path=tmp_path / "t.csv", device=CPU)
    theirs = JR.run_batch_evaluation(root, csv_path=tmp_path / "j.csv")
    _close(ours, theirs)
    assert TR.format_summary_report(ours["summary"]).splitlines()[:2] == \
        JR.format_summary_report(theirs["summary"]).splitlines()[:2]

    a, b = _degraded(2)
    for key, t in TR.difference_maps(a, b).items():
        np.testing.assert_array_equal(t, JR.difference_maps(a, b)[key])

    png, rq, _ = pairs[0]
    jpg = tmp_path / "b.jpg"
    assert TR.compress_with_jpeg(png, jpg, 80) == JR.compress_with_jpeg(png, tmp_path / "c.jpg", 80)
    rows_t = [TR.three_way_comparison(p, jpg, r, device=CPU) for p, r, _ in pairs]
    rows_j = [JR.three_way_comparison(p, jpg, r) for p, r, _ in pairs]
    _close(rows_t, rows_j)
    TR.summary_csv(rows_t, tmp_path / "ts.csv")
    JR.summary_csv(rows_j, tmp_path / "js.csv")
    st, sj = list(csv.reader(open(tmp_path / "ts.csv"))), list(csv.reader(open(tmp_path / "js.csv")))
    assert [r[0] for r in st] == [r[0] for r in sj] and st[0] == sj[0]
    _close([[float(x) for x in r[1:]] for r in st[1:]], [[float(x) for x in r[1:]] for r in sj[1:]])
    TR.html_report(rows_t, tmp_path / "t.html")
    JR.html_report(rows_j, tmp_path / "j.html")
    assert (tmp_path / "t.html").read_text() == (tmp_path / "j.html").read_text()


def test_figures_write_files(tmp_path):
    """The figure functions (matplotlib, imported inside each) write PNGs."""
    from roibasedimagecompression_torch.models import segment

    a, b = _degraded(2)
    results = [TH.PairResult("x", 30.0 + i, 0.9, 10.0, 1000, 20480, 64) for i in range(3)]
    TR.save_metric_histograms(results, tmp_path / "h.png")
    mask = np.zeros((128, 160), bool)
    mask[10:60, 20:90] = True
    regions = segment.extract_regions(mask, "roi")
    TR.save_region_grid(a, regions, tmp_path / "g.png")
    row = {"jpeg": {"bpp": 1.0, "psnr": 30.0}, "rhccq": {"bpp": 1.2, "psnr": 33.0}}
    TR.rd_scatter([row], tmp_path / "rd.png")
    metrics = TR.comparison_figure(a, b, tmp_path / "c.png", device=CPU)
    _close(metrics, JM.quality_metrics(a, b))
    shadows = TCOL.rgb_to_lab_cv2(torch.from_numpy(a))[..., 0].numpy() < 100
    TE.clahe_parameter_sweep(a, shadows, TE.CLAHE_PRESETS[:2], tmp_path / "s.png", device=CPU)
    for name in ("h", "g", "rd", "c", "s"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name


def test_cv2_lab_conversions_match_jax():
    """Over all 2^24 colours (and Lab triples), both 8-bit conversions equal
    the JAX functions called op by op, as the JAX package's enhancer calls
    them, bit for bit.  Jitted alone, XLA fuses the JAX functions otherwise:
    against that, equal but for one unit on at most 2^-14 of 2^20 random
    inputs."""
    every = np.arange(1 << 24, dtype=np.uint32)
    x_all = np.stack([(every >> 16) & 255, (every >> 8) & 255, every & 255], -1).astype(np.uint8)
    for ours, theirs in ((TCOL.rgb_to_lab_cv2, JCOL.rgb_to_lab_cv2), (TCOL.lab_cv2_to_rgb, JCOL.lab_cv2_to_rgb)):
        for s in range(0, 1 << 24, 1 << 22):
            x = x_all[s : s + (1 << 22)]
            np.testing.assert_array_equal(ours(torch.from_numpy(x)).numpy(), np.asarray(theirs(jnp.asarray(x))))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1 << 20, 3)).astype(np.uint8)
    for ours, theirs in (
        (TCOL.rgb_to_lab_cv2(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(JCOL.rgb_to_lab_cv2)(x))),
        (TCOL.lab_cv2_to_rgb(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(JCOL.lab_cv2_to_rgb)(x))),
    ):
        diff = np.abs(ours.astype(int) - theirs)
        assert diff.max() <= 1 and (diff.max(axis=1) > 0).sum() <= (1 << 6)


@pytest.mark.parametrize("n,clip,tiles", [(50, 3.0, 16), (1000, 2.0, 4), (20011, 4.0, 16), (4096, 8.0, 8)])
def test_clahe_1d_matches_jax(n, clip, tiles):
    v = np.clip(np.random.default_rng(n).normal(60, 25, n), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        TCL.clahe_1d(torch.from_numpy(v), clip, tiles).numpy(),
        np.asarray(JCL.clahe_1d(jnp.asarray(v), clip_limit=clip, n_tiles=tiles)),
    )


@pytest.mark.parametrize("h,w,clip,grid", [(128, 160, 3.0, 8), (37, 53, 2.0, 4), (200, 90, 8.0, 2)])
def test_clahe_2d_matches_jax(h, w, clip, grid):
    g = np.clip(np.random.default_rng(h).normal(100, 50, (h, w)), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        TCL.clahe_2d(torch.from_numpy(g), clip, grid).numpy(),
        np.asarray(JCL.clahe_2d(jnp.asarray(g), clip_limit=clip, grid=grid)),
    )


@pytest.mark.parametrize("seed,dark", [(0, False), (2, True), (62, True)])
def test_enhance_matches_jax(seed, dark):
    img = synthetic_image(seed, 128, 160)
    if dark:
        img = (img * 0.45).astype(np.uint8)
    np.testing.assert_array_equal(TE.enhance_shadows(img, device=CPU), JE.enhance_shadows(img))
    np.testing.assert_array_equal(TE.clahe_full_image(img, device=CPU), JE.clahe_full_image(img))
    shadows = np.asarray(JCOL.rgb_to_lab_cv2(jnp.asarray(img)))[..., 0] < 100
    np.testing.assert_array_equal(
        TE.clahe_custom_shadows(img, shadows, device=CPU), JE.clahe_custom_shadows(img, shadows)
    )


def _noisy(seed, h=128, w=160, sigma=14.0):
    img = synthetic_image(seed, h, w).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, sigma, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("method", ["mediancut", "kmeans-mc"])
def test_split_methods_match_jax_and_keep_the_law(method):
    """tier1_table at both split methods equals the JAX table on a noisy
    image, and no cluster of a segment exceeds its max_colors_per_cluster
    (clusters of <= 2 colours are never split)."""
    img = _noisy(22, 128, 160, 14.0)
    seg = np.ones((128, 160), np.int32)
    seg[64:, :] = 2
    seg[:, :40] = 3
    qual = np.array([0.0, 20.0, 35.0, 10.0])
    jt = JQB.tier1_table(img, seg, qual, split_method=method, weighted_split=False)
    tt = TQB.tier1_table(img, seg, qual, torch.device(CPU), split_method=method)
    np.testing.assert_array_equal(tt["cluster_of_pair"], jt["cluster_of_pair"])
    np.testing.assert_array_equal(tt["cluster_colors"], jt["cluster_colors"])
    seg_of_pair, cop = tt["seg_of_pair"], tt["cluster_of_pair"]
    for s in (1, 2, 3):
        sel = seg_of_pair == s
        params = tcfg.clustering_params(int(sel.sum()) + 1, float(qual[s]))
        sizes = np.bincount(cop[sel], minlength=int(cop.max()) + 1)
        assert sizes.max() <= max(params.max_colors_per_cluster, 2)


def test_kmeans_padded_init_rows_never_win():
    """Given initial centres, rows >= k of the padded (B, k_max, 3) block are
    masked: even a padding row that sits on every point wins no label."""
    pts = torch.tensor([[[10.0, 10, 10], [12, 10, 10], [200, 200, 200], [0, 0, 0]]])
    valid = torch.tensor([[True, True, True, True]])
    init = torch.zeros((1, 4, 3))
    init[0, 0] = pts[0, 0]
    init[0, 1] = pts[0, 2]  # rows 2, 3 are padding; row 2 sits on the black point
    labels = TCLU.kmeans_rows(pts, valid, [2], k_max=4, init_centers=init)
    assert labels.max() < 2 and labels[0, 3] == 0


def test_split_methods_encode_and_raise():
    """encode takes every split method; an unknown one raises."""
    import roibasedimagecompression_torch as rtt

    img = synthetic_image(5, 96, 128)
    for method in ("mediancut", "kmeans-mc"):
        out = rtt.decode(rtt.encode(img, tcfg.CodecConfig(split_method=method), device=CPU))
        assert out.shape == img.shape
    with pytest.raises(ValueError):
        TQB._split_oversized_batched(
            np.zeros((4, 3), np.uint8), np.zeros(4, np.int64), np.ones(4, np.int64), 1, 42,
            torch.device(CPU), method="lloyd",
        )
    assert dataclasses.asdict(tcfg.CodecConfig(split_method="kmeans-mc"))["split_method"] == \
        dataclasses.asdict(jcfg.CodecConfig(split_method="kmeans-mc"))["split_method"]


@pytest.fixture(scope="module")
def slic_mode(request):
    """RHCCQ_SLIC_PALLAS for both packages: "1" (the Pallas form), "0" or
    None (unset: the JAX default's expanded form).  Module-scoped, so pytest
    runs the tests of one mode together; the JAX package reads the variable
    at trace time, so its caches are dropped when the mode is set and when it
    is restored."""
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


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, scope="module")
@pytest.mark.parametrize("env,config", [
    ({"RHCCQ_SPLIT_METHOD": "mediancut"}, {}),
    ({"RHCCQ_SPLIT_MARGIN": "2.0"}, {}),
    ({"RHCCQ_HYBRID_CUTOFF": "16"}, {}),
    ({"RHCCQ_HYBRID_MARGIN": "2.0"}, {"split_method": "hybrid"}),
])
def test_split_overrides_from_the_environment(slic_mode, monkeypatch, env, config):
    """Each override changes the bytes, and both packages read it alike."""
    import roibasedimagecompression_tpu as rtc

    img = _noisy(71, 96, 128, 14.0)
    jconfig = jcfg.CodecConfig(**config)
    tconfig = tcfg.from_dict(dataclasses.asdict(jconfig))
    plain = rtt.encode(img, tconfig, device="cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = rtt.encode(img, tconfig, device="cpu")
    assert ours == rtc.encode(img, jconfig)
    assert ours != plain


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("value,raises", [("1", True), ("yes", True), ("0", False), ("", False)])
def test_weighted_split_from_the_environment_raises(monkeypatch, value, raises):
    """RHCCQ_WEIGHTED_SPLIT turns the weighted split on (`raises`: it used
    to raise naming ROADMAP A12c) or off, read alike by both packages: the
    same bytes through `encode` and `encode_many`, and with it on other
    bytes than with it off (the k-means split carries the weights)."""
    import roibasedimagecompression_tpu as rtc

    img = _noisy(72, 64, 80, 14.0)
    kw = dict(split_method="kmeans")
    plain = rtt.encode(img, tcfg.CodecConfig(**kw), device="cpu")
    monkeypatch.setenv("RHCCQ_WEIGHTED_SPLIT", value)
    ours = rtt.encode(img, tcfg.CodecConfig(**kw), device="cpu")
    assert ours == rtc.encode(img, jcfg.CodecConfig(**kw))
    assert TSTREAM.encode_many([img], tcfg.CodecConfig(**kw), device="cpu") == [ours]
    assert (ours != plain) == raises
