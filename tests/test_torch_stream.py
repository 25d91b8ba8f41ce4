"""PyTorch port, batch and stream path: the device pair table, the batch
threshold selectors, `encode_many` / `encode_stream` and the quality metrics,
each held against the JAX package on the same inputs (JAX on the CPU, the
port with device="cpu", where its kernels' plain versions run)."""

import dataclasses
import os
import functools
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.ops import canny as JCANNY
from roibasedimagecompression_tpu.ops import colors as JCOL
from roibasedimagecompression_tpu.ops import conv as JCONV
from roibasedimagecompression_tpu.ops import hist as JH
from roibasedimagecompression_tpu.ops import metrics as JM
from roibasedimagecompression_tpu.ops import pairs as JPAIRS
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch import native as tnative
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.ops import canny as TCANNY
from roibasedimagecompression_torch.ops import colors as TCOL
from roibasedimagecompression_torch.ops import conv as TCONV
from roibasedimagecompression_torch.ops import hist as TH
from roibasedimagecompression_torch.ops import metrics as TM
from roibasedimagecompression_torch.ops import pairs as TPAIRS
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = torch.device("cpu")


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


# ---------------------------------------------------------------------------
# Device pair table (all integer: exact).
# ---------------------------------------------------------------------------

def _pair_case(name):
    rng = np.random.default_rng(7)
    if name == "random":
        return (rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
                rng.integers(0, 5, (48, 64)).astype(np.int32))
    if name == "blacks":  # black pairs to repair, and a black-only segment
        img = rng.integers(0, 4, (48, 64, 3)).astype(np.uint8)
        seg = rng.integers(0, 5, (48, 64)).astype(np.int32)
        img[0], seg[0] = 0, 1
        img[1], seg[1] = 0, 6
        return img, seg
    if name == "cap_boundary":  # exactly 4096 pairs: n_pairs == cap
        vals = np.arange(4096, dtype=np.int64) + 1
        img = np.stack([(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF], axis=1)
        return img.astype(np.uint8).reshape(64, 64, 3), np.ones((64, 64), np.int32)
    if name == "all_background":
        return (rng.integers(0, 256, (16, 16, 3)).astype(np.uint8), np.zeros((16, 16), np.int32))
    if name == "wide_segments":  # ids >= 2^16 (JAX takes its 12-byte table here)
        return (rng.integers(0, 8, (40, 50, 3)).astype(np.uint8),
                (rng.integers(0, 4, (40, 50)) * 40_000).astype(np.int32))
    if name == "wide_counts":  # a pair count above 2^16 (JAX: through count_hi8)
        img = np.full((300, 300, 3), 77, np.uint8)
        img[0, 0] = (1, 2, 3)
        return img, np.ones((300, 300), np.int32)
    raise KeyError(name)


@pytest.mark.parametrize(
    "case", ["random", "blacks", "cap_boundary", "all_background", "wide_segments", "wide_counts"]
)
def test_device_pair_table_matches_jax_and_native(case):
    img, seg = _pair_case(case)
    uniq, inverse, counts = tnative.pack_pairs(img, seg)
    ours = TPAIRS.DevicePairTable(seg, tall_img=img, device=CPU)
    theirs = JPAIRS.DevicePairTable(seg, tall_img=img)
    for got in (ours, theirs):
        np.testing.assert_array_equal(got.uniq, uniq)
        np.testing.assert_array_equal(got.counts, counts)
    assert ours.n_pairs == theirs.n_pairs == len(uniq)
    assert ours.uniq.dtype == np.int64 and ours.counts.dtype == np.int64
    if case == "cap_boundary":
        assert ours.n_pairs == 4096
    if case == "wide_counts":
        assert counts.max() > (1 << 16)
    if len(uniq) == 0:
        assert ours.colors_dev is None and theirs.colors_dev is None
        return
    # Post-repair colors: the JAX table's and the host repair's.
    u, c = uniq.copy(), counts.copy()
    m, remap = tnative.black_repair_pairs(u, c, None, return_remap=True)
    host_colors = tnative.split_pair_uniq(u[:m])[2].astype(np.uint8)
    dev_colors = ours.colors_dev.numpy()
    np.testing.assert_array_equal(dev_colors[:m], host_colors)
    np.testing.assert_array_equal(dev_colors, np.asarray(theirs.colors_dev))
    assert (dev_colors[m:] == 0).all()
    # paint with the identity table gives every pixel its pair row.
    flat = ours.paint(np.arange(len(uniq), dtype=np.int64))
    mask = seg.reshape(-1) > 0
    np.testing.assert_array_equal(flat[mask], inverse)
    assert (flat[~mask] == 0).all()
    np.testing.assert_array_equal(flat, theirs.paint(np.arange(len(uniq), dtype=np.int64)))


@pytest.mark.parametrize("n_idx", [200, 3000])  # uint8 and uint16 index maps
def test_paint_and_refit_sums_match_jax(n_idx):
    rng = np.random.default_rng(n_idx)
    b, h, w = 3, 40, 50
    img = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    img[:, :4] = 0
    seg = rng.integers(0, 9, (b * h, w)).astype(np.int32)
    ours = TPAIRS.DevicePairTable(seg, images_dev=torch.from_numpy(img))
    theirs = JPAIRS.DevicePairTable(seg, tall_img=img.reshape(b * h, w, 3))
    u, c = ours.uniq.copy(), ours.counts.copy()
    m, remap = tnative.black_repair_pairs(u, c, None, return_remap=True)
    idx_of_pair = rng.integers(0, n_idx, m).astype(np.int32)
    k_pad = TCODEC._pow2_refit(n_idx)
    assert k_pad == JCODEC._pow2_refit(n_idx)
    flat, sums = ours.paint(idx_of_pair, remap, refit_bins=(b, h * w, k_pad))
    jflat, jsums = theirs.paint(idx_of_pair, remap, refit_bins=(b, h * w, k_pad))
    assert flat.dtype == jflat.dtype == (np.uint8 if n_idx <= 256 else np.uint16)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(sums, jsums)
    # The host paint and a host bincount of the original pixels.
    inverse = tnative.pack_pairs(img.reshape(b * h, w, 3), seg)[1]
    want = np.zeros(b * h * w, np.int64)
    mask = seg.reshape(-1) > 0
    want[mask] = idx_of_pair[remap][inverse]
    np.testing.assert_array_equal(flat, want)
    bins = (np.arange(b * h * w) // (h * w)) * k_pad + want
    pix = img.reshape(-1, 3).astype(np.int64)
    for ch, col in enumerate([np.ones(len(pix), np.int64), pix[:, 0], pix[:, 1], pix[:, 2]]):
        host = np.bincount(bins[mask], weights=col[mask], minlength=b * k_pad)
        np.testing.assert_array_equal(sums[:, ch], host.astype(np.int64))
    # The finished refit equals the JAX one.
    pal = rng.integers(0, 256, (n_idx, 3)).astype(np.uint8)
    pal[0] = 0
    np.testing.assert_array_equal(
        TCODEC._apply_refit_sums(pal, sums[:n_idx]), JCODEC._apply_refit_sums(pal, jsums[:n_idx])
    )


@pytest.mark.parametrize("seed,sigma,split", [(71, 0.0, "hybrid"), (72, 14.0, "hybrid"), (73, 18.0, "kmeans")])
def test_tier1_table_device_pairs_equals_host_pack(seed, sigma, split):
    """tier1_table on the device pair table equals tier1_table on the host
    pack key for key (and the JAX table), and both paint the same indices."""
    b, h, w = 2, 96, 128
    imgs = [_noisy(seed + k, h, w, sigma) if sigma else synthetic_image(seed + k, h, w) for k in range(b)]
    rng = np.random.default_rng(seed)
    # A blocky segment map with background, stacked tall with unique ids.
    seg = np.kron(rng.integers(0, 7, (b * h // 16, w // 16)), np.ones((16, 16), np.int64)).astype(np.int32)
    seg[h:][seg[h:] > 0] += 6
    tall = np.concatenate(imgs, axis=0)
    seg_q = np.concatenate([[0.0], np.where(np.arange(12) % 2, 20.0, 10.0)])
    kw = dict(seed=42, weighted=True, split_method=split, split_margin=1.5)
    host = TQB.tier1_table(tall, seg, seg_q, CPU, **kw)
    dpt = TPAIRS.DevicePairTable(seg, images_dev=torch.from_numpy(np.stack(imgs)))
    dev = TQB.tier1_table(tall, seg, seg_q, CPU, device_pairs=dpt, **kw)
    jdev = JQB.tier1_table(tall, seg, seg_q, weighted_split=False,
                           device_pairs=JPAIRS.DevicePairTable(seg, tall_img=tall), **kw)
    assert dev["inverse"] is None and dev["device_pairs"] is dpt
    assert host["device_pairs"] is None and host["repair_remap"] is None
    for key in ("seg_of_pair", "cluster_of_pair", "cluster_colors", "mask", "pair_weights"):
        np.testing.assert_array_equal(dev[key], host[key], err_msg=key)
        np.testing.assert_array_equal(dev[key], jdev[key], err_msg=key)
    np.testing.assert_array_equal(dev["repair_remap"], jdev["repair_remap"])
    seg_group = np.concatenate([[0], 1 + (np.arange(12) % 2)]).astype(np.int32)
    image_of_seg = np.concatenate([[0], np.repeat(np.arange(b), 6)]).astype(np.int32)
    config = tcfg.CodecConfig(split_method=split)
    originals = np.stack(imgs)
    a = TCODEC.tiers23_palette_indices(host, seg_group, image_of_seg, b, (h, w), config, CPU,
                                       refit_originals=originals)
    d = TCODEC.tiers23_palette_indices(dev, seg_group, image_of_seg, b, (h, w), config, CPU,
                                       refit_originals=originals)
    for (pa, ia), (pd, idd) in zip(a, d):
        np.testing.assert_array_equal(pa, pd)
        np.testing.assert_array_equal(ia, idd)
        assert ia.dtype == idd.dtype


# ---------------------------------------------------------------------------
# Thresholds and their float pieces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", [(81, 128, 160, 0.0), (82, 96, 144, 6.0), (83, 160, 128, 25.0), (84, 77, 91, 0.0)])
def test_threshold_selectors_match_jax(fixture):
    """(lows, highs) exact: the thresholds are floors of float32
    interpolations, and one unit moves the masks and every byte."""
    seed, h, w, sigma = fixture
    batch = np.stack([
        _noisy(seed * 10 + k, h, w, sigma) if sigma else synthetic_image(seed * 10 + k, h, w)
        for k in range(3)
    ])
    for ours, theirs in (
        (TCANNY.select_thresholds_many(batch), JCANNY.select_thresholds_many(batch)),
        (TCANNY.fast_thresholds_many(batch, CPU), JCANNY.fast_thresholds_many(batch)),
    ):
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32 and a.shape == (3,)
            np.testing.assert_array_equal(a, b)


def test_masked_percentile_matches_jax(rng):
    """1e-6 relative on random floats (bit-equal in practice: the port rounds
    the interpolation where XLA's CPU code does), exact on integers."""
    for t in range(40):
        n = int(rng.integers(50, 4000))
        values = (rng.random(n) * 1000).astype(np.float32)
        if t % 2:
            values = np.sqrt(rng.integers(0, 2000, n).astype(np.float32))
        mask = rng.random(n) < 0.7
        for q in (10.0, 25.0, 75.0, 90.0):
            want = float(jax.jit(functools.partial(JH.masked_percentile, q=q))(
                jnp.asarray(values), jnp.asarray(mask)))
            got = float(TH.masked_percentile(torch.from_numpy(values), torch.from_numpy(mask), q))
            assert got == pytest.approx(want, rel=1e-6)
            ints = np.floor(values)
            want = float(jax.jit(functools.partial(JH.masked_percentile, q=q))(
                jnp.asarray(ints), jnp.asarray(mask)))
            assert float(TH.masked_percentile(torch.from_numpy(ints), torch.from_numpy(mask), q)) == want
    # Rows of a batch reduce on their own; an empty mask gives 0.
    v = torch.from_numpy(rng.random((3, 64)).astype(np.float32))
    m = torch.from_numpy(rng.random((3, 64)) < 0.5)
    m[2] = False
    got = TH.masked_percentile(v, m, 50.0)
    assert got.shape == (3,) and float(got[2]) == 0.0
    assert float(got[0]) == pytest.approx(float(np.percentile(v[0][m[0]].numpy(), 50.0)), rel=1e-6)


def test_gray_cv2_and_sobel_cv2_match_jax(rng):
    """Exact: uint8 gray on every color whose weighted sum ends in .5 (where
    the rounding order decides) and on a random sample; integer Sobel."""
    r, g, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    half = (299 * r + 587 * g + 114 * b) % 1000 == 500
    colors = np.concatenate([
        np.stack([r[half], g[half], b[half]], axis=1),
        rng.integers(0, 256, (200_000, 3)),
    ]).astype(np.uint8)
    want = np.asarray(jax.jit(JCOL.rgb_to_gray_cv2)(jnp.asarray(colors)))
    np.testing.assert_array_equal(TCOL.rgb_to_gray_cv2(torch.from_numpy(colors)).numpy(), want)
    gray = rng.integers(0, 256, (2, 37, 53)).astype(np.uint8)
    gx, gy = TCONV.sobel_cv2(torch.from_numpy(gray))
    for k in range(2):
        jx, jy = JCONV.sobel_cv2(jnp.asarray(gray[k]))
        np.testing.assert_array_equal(gx[k].numpy(), np.asarray(jx))
        np.testing.assert_array_equal(gy[k].numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# encode_many / encode_stream.
# ---------------------------------------------------------------------------

def _configs(name):
    if name == "default":
        return tcfg.CodecConfig(), jcfg.CodecConfig()
    return tcfg.CodecConfig.low_latency(), jcfg.CodecConfig.low_latency()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse)


def _canonical(seg):
    """Segment ids renumbered by first appearance: two maps of one partition
    become equal whatever their numbering."""
    _, first, inv = np.unique(seg.reshape(-1), return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv].reshape(seg.shape)


def _seg_maps(imgs, tconfig, jconfig):
    """The segment maps of both packages for a batch, (b, h, w) each, every
    image's ids renumbered by first appearance."""
    def one(canny, roi_fn, extract, build, config):
        batch = np.stack(imgs)
        if config.fast_edges:
            lows, highs = canny(batch)
        else:
            lows, highs = zip(*[roi_fn["pair"](im) for im in imgs])
        regs = []
        for k, im in enumerate(imgs):
            roi, nonroi = roi_fn["masks"](im, config, lows[k], highs[k])
            regs.append(extract(im, roi, nonroi, config))
        return np.stack([_canonical(r[0]) for r in build(list(imgs), regs, config)])

    from roibasedimagecompression_tpu.models import roi_fused as JROI
    from roibasedimagecompression_torch.models import roi_fused as TROI

    ms = tcfg.min_region_size(imgs[0].size)
    ours = one(lambda b: TCANNY.fast_thresholds_many(b, CPU),
               {"pair": TCANNY.select_thresholds_pair, "masks": TROI.roi_masks_fast},
               lambda im, r, n, c: TCODEC._extract_and_assign(im, r, n, c, ms),
               lambda i, r, c: TCODEC.build_segment_maps_many(i, r, c, CPU), tconfig)
    theirs = one(JCANNY.fast_thresholds_many,
                 {"pair": JCANNY.select_thresholds_pair, "masks": JROI.roi_masks_fast},
                 lambda im, r, n, c: JCODEC._extract_and_assign(im, r, n, c, ms),
                 JCODEC.build_segment_maps_many, jconfig)
    return ours, theirs


def _assert_same_batch(imgs, ours, theirs, tconfig, jconfig):
    """Bytes equal; where a float argmin ties and a segment map differs, the
    whole-encode rule of the one-image tests: segment maps agree on >= 99.5 %
    of pixels, PSNR within 0.05 dB, size within 1 %."""
    if ours == theirs:
        return
    sa, sb = _seg_maps(imgs, tconfig, jconfig)
    assert not np.array_equal(sa, sb), "equal segment maps but different bytes"
    assert np.mean(sa == sb) >= 0.995
    for im, a, b in zip(imgs, ours, theirs):
        assert abs(_psnr(im, rtt.decode(a)) - _psnr(im, rtt.decode(b))) <= 0.05
        assert abs(len(a) - len(b)) <= 0.01 * len(b)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("slic_mode", ["1", None], indirect=True, ids=["pallas", "default"], scope="module")
@pytest.mark.parametrize("preset", ["default", "low_latency"])
def test_encode_many_matches_jax(slic_mode, monkeypatch, preset):
    """Seed 62 under fast edges has a small ROI region demoted into the
    non-ROI raster, where two regions of one kind overlap."""
    tconfig, jconfig = _configs(preset)
    imgs = [synthetic_image(60 + k, 128, 160) for k in range(3)]
    theirs = JSTREAM.encode_many(imgs, jconfig)
    ours = TSTREAM.encode_many(imgs, tconfig, device="cpu")
    _assert_same_batch(imgs, ours, theirs, tconfig, jconfig)
    if preset == "low_latency":
        np.testing.assert_array_equal(*_seg_maps(imgs, tconfig, jconfig))
    monkeypatch.setenv("RHCCQ_DEVICE_PAIRS", "0")
    assert TSTREAM.encode_many(imgs, tconfig, device="cpu") == ours
    monkeypatch.setenv("RHCCQ_DEVICE_PAIRS", "1")
    assert TSTREAM.encode_many(imgs, tconfig, device="cpu") == ours
    for im, data in zip(imgs, ours):
        out = rtt.decode(data)
        assert out.shape == im.shape and _psnr(im, out) > 28.0


@pytest.mark.parametrize("preset", ["default", "low_latency"])
def test_encode_many_single_matches_encode(preset):
    tconfig, _ = _configs(preset)
    for img in (_noisy(91, 96, 128, 12.0), synthetic_image(62, 128, 160)):
        assert TSTREAM.encode_many([img], tconfig, device="cpu") == [
            rtt.encode(img, tconfig, device="cpu")
        ]


def test_encode_many_u16_indices_device_pairs(monkeypatch, rng):
    """More than 256 final colors: the wide paint; bytes equal the host pack's
    and the JAX package's."""
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    kw = dict(roi_quality=95, nonroi_quality=95)
    ours = TSTREAM.encode_many([img], tcfg.CodecConfig(**kw), device="cpu")
    assert rtt.unpack(ours[0]).n_colors > 256
    monkeypatch.setenv("RHCCQ_DEVICE_PAIRS", "0")
    assert TSTREAM.encode_many([img], tcfg.CodecConfig(**kw), device="cpu") == ours
    assert JSTREAM.encode_many([img], jcfg.CodecConfig(**kw)) == ours


def test_encode_many_argument_laws(monkeypatch):
    a, b = synthetic_image(1, 64, 64), synthetic_image(2, 64, 80)
    assert TSTREAM.encode_many([], device="cpu") == []
    with pytest.raises(ValueError, match="same-shape"):
        TSTREAM.encode_many([a, b], device="cpu")
    # The batch entry points ignore `batched`, as the JAX package's do.
    batched = TSTREAM.encode_many([a], device="cpu")
    assert TSTREAM.encode_many([a], tcfg.CodecConfig(batched=False), device="cpu") == batched
    assert TSTREAM.encode_stream([[a]], tcfg.CodecConfig(batched=False), device="cpu") == [batched]
    # Region fusion is ported (it used to raise naming ROADMAP A12c): the
    # batch entry point writes the one-image path's bytes.
    fused = tcfg.CodecConfig(region_fusion=True)
    assert TSTREAM.encode_many([a], fused, device="cpu") == [rtt.encode(a, fused, device="cpu")]
    # The canvas tiers path is ported: fill_black_holes and
    # RHCCQ_CANVAS_TIERS=1 encode, the latter to the composed path's bytes.
    composed = TSTREAM.encode_many([a], device="cpu")
    assert TSTREAM.encode_many([a], tcfg.CodecConfig(fill_black_holes=50), device="cpu")
    monkeypatch.setenv("RHCCQ_CANVAS_TIERS", "1")
    assert TSTREAM.encode_many([a], device="cpu") == composed
    monkeypatch.delenv("RHCCQ_CANVAS_TIERS")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TSTREAM.encode_many([a])
        with pytest.raises(RuntimeError, match="CUDA"):
            TSTREAM.encode_stream([[a], [a]])
    # A failing batch still opens the next batch's gate.
    done = threading.Event()
    with pytest.raises(ValueError):
        TSTREAM.encode_many([a, b], device="cpu", _frontend_done=done)
    assert done.is_set()


def test_encode_stream_matches_sequential():
    imgs = [synthetic_image(60 + k, 96, 128) for k in range(4)]
    batches = [imgs[:2], imgs[2:], [imgs[3], imgs[0]]]
    seq = [TSTREAM.encode_many(bt, device="cpu") for bt in batches]
    assert TSTREAM.encode_stream(batches, workers=2, device="cpu") == seq
    assert TSTREAM.encode_stream(batches, workers=1, device="cpu") == seq
    assert TSTREAM.encode_stream([], workers=2, device="cpu") == []


def test_low_latency_preset_converts():
    jc = jcfg.CodecConfig.low_latency()
    tc = tcfg.CodecConfig.low_latency()
    assert tcfg.from_dict(dataclasses.asdict(jc)) == tc
    assert (tc.fast_edges, tc.split_margin, tc.container_level) == (True, 3.0, 7)
    over = dict(roi_quality=30.0, container_level=10)
    assert tcfg.from_dict(dataclasses.asdict(jcfg.CodecConfig.low_latency(**over))) == (
        tcfg.CodecConfig.low_latency(**over)
    )


# ---------------------------------------------------------------------------
# Metrics, and the registries the stream's threads share.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,sigma", [(5, 4.0), (6, 20.0), (7, 0.0)])
def test_metrics_match_jax(seed, sigma):
    """PSNR within 1e-4 dB (float32 sums in another order); SSIM, eager,
    and every value of the jitted `quality_metrics` bit for bit
    (ops/metrics.py follows XLA's CPU arithmetic)."""
    a = synthetic_image(seed, 96, 128)
    b = _noisy(seed, 96, 128, sigma) if sigma else (a // 8) * 8
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(TM.psnr(ta, tb)) == pytest.approx(float(JM.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-4)
    assert float(TM.ssim(ta, tb)) == float(JM.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert float(TM.ssim(ta[..., 0], tb[..., 0])) == float(JM.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])))
    assert TM.quality_metrics(a, b, device="cpu") == JM.quality_metrics(a, b)
    assert float(TM.psnr(ta, ta)) == float("inf") and float(TM.ssim(ta, ta)) == pytest.approx(1.0)


def test_shared_registries_survive_threads():
    """The stage registry, the counters and the kernels' launch record are
    written from the stream's worker threads: no update may be lost."""
    from roibasedimagecompression_torch.ops.cuda import _build

    assert isinstance(_build._launched_lock, type(threading.Lock()))
    timing.reset_stages()
    n_threads, n_calls = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with timing.stage_timer("stress"):
                    timing.count("stress", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timing.stage_report()["stress"]["calls"] == n_threads * n_calls
    assert timing.counters()["stress"] == n_threads * n_calls
    timing.reset_stages()
