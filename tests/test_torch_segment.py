"""PyTorch port, frontend and segmentation: thresholds, ROI masks and region
lists, split scores and segment counts, and SLIC labels, each against the
JAX package on the same synthetic images."""

import os

import jax
import numpy as np
import pytest
import torch

from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import roi_fused as JROI
from roibasedimagecompression_tpu.models import segment as JSEG
from roibasedimagecompression_tpu.ops import canny as JCANNY
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import roi_fused as TROI
from roibasedimagecompression_torch.models import segment as TSEG
from roibasedimagecompression_torch.ops import canny as TCANNY
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = torch.device("cpu")


@pytest.fixture()
def one_thread():
    """Runs a test's torch work on one thread and restores the count after:
    the suite runs several worker processes on the host's cores, and a torch
    thread pool per worker only adds contention to these encode-heavy tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
IMAGES = [(11, 128, 160), (12, 160, 128), (13, 96, 128)]


def _regions(img):
    """The JAX package's frontend: thresholds, masks and region lists."""
    config = jcfg.CodecConfig()
    low, high = JCANNY.select_thresholds_pair(img)
    roi, nonroi = JROI.roi_masks_fast(img, config, low, high)
    regs = JCODEC._extract_and_assign(img, roi, nonroi, config, jcfg.min_region_size(img.size))
    return (low, high), (roi, nonroi), regs


@pytest.mark.parametrize("seed,h,w", IMAGES)
def test_frontend_matches_jax(seed, h, w):
    img = synthetic_image(seed, h, w)
    (low, high), (roi, nonroi), (jroi, jnon) = _regions(img)
    assert TCANNY.select_thresholds_pair(img) == (low, high)
    troi_mask, tnon_mask = TROI.roi_masks_fast(img, tcfg.CodecConfig(), low, high)
    np.testing.assert_array_equal(troi_mask, roi)
    np.testing.assert_array_equal(tnon_mask, nonroi)
    troi, tnon = TCODEC._extract_and_assign(
        img, troi_mask, tnon_mask, tcfg.CodecConfig(), tcfg.min_region_size(img.size)
    )
    for a, b in ((troi, jroi), (tnon, jnon)):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert (ra.bbox, ra.area, ra.kind) == (rb.bbox, rb.area, rb.kind)
            np.testing.assert_array_equal(ra.bbox_mask, rb.bbox_mask)


def _crops(img, regions):
    roi, nonroi = regions
    regs = list(nonroi) + list(roi)
    crops = [img[r.bbox[0] : r.bbox[2], r.bbox[1] : r.bbox[3]] for r in regs]
    return crops, [r.bbox_mask for r in regs]


@pytest.mark.parametrize("seed,h,w", IMAGES)
def test_split_scores_match_jax(seed, h, w):
    img = synthetic_image(seed, h, w)
    _, _, regs = _regions(img)
    crops, masks = _crops(img, regs)
    # Whole-image and one transposed crop as extra rows.
    crops.append(img)
    masks.append(np.ones(img.shape[:2], bool))
    want = JSEG.split_scores_many(crops, masks)
    got = TSEG.split_scores_many(crops, masks, CPU)
    # Bit for bit: every reduction adds in XLA's CPU order (models/segment.py).
    np.testing.assert_array_equal(np.array(got), np.array(want))
    n_want = [jcfg.logistic_segments(s[0], jcfg.segment_window(c.size)) for s, c in zip(want, crops)]
    assert TSEG.optimal_segments_many(crops, masks, CPU) == n_want


def test_split_score_device_batch_rows_equal_host_rows():
    """Rows sliced from the device batch score exactly as host-packed rows."""
    img = synthetic_image(14, 128, 160)
    _, _, regs = _regions(img)
    crops, masks = _crops(img, regs)
    h, w = img.shape[:2]
    reg_a = np.zeros((1, h, w), np.int32)
    reg_b = np.zeros((1, h, w), np.int32)
    sources = []
    for j, r in enumerate(list(regs[1]) + list(regs[0])):
        kind = 1 if r.kind == "roi" else 0
        (reg_b if kind else reg_a)[0, r.bbox[0] : r.bbox[2], r.bbox[1] : r.bbox[3]][r.bbox_mask] = j + 1
        sources.append((0, r.bbox[0], r.bbox[1], r.bbox[2] - r.bbox[0], r.bbox[3] - r.bbox[1], j + 1, kind))
    dbatch = TSEG.DeviceBatch(img[None], reg_a, reg_b, CPU)
    a = TSEG.split_scores_many(crops, masks, CPU, sources=sources, dbatch=dbatch)
    b = TSEG.split_scores_many(crops, masks, CPU)
    assert a == b


@pytest.fixture()
def slic_pallas_mode(monkeypatch):
    """Run the JAX SLIC in its Pallas mode (the port's semantics).  The mode
    is read at trace time, so cached traces are dropped on both sides."""
    monkeypatch.setenv("RHCCQ_SLIC_PALLAS", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("RHCCQ_SLIC_PALLAS")
    jax.clear_caches()


@pytest.mark.parametrize("seed,h,w", IMAGES)
def test_slic_matches_jax_pallas_mode(slic_pallas_mode, seed, h, w):
    img = synthetic_image(seed, h, w)
    _, _, regs = _regions(img)
    crops, masks = _crops(img, regs)
    n_segs = JSEG.optimal_segments_many(crops, masks)
    want = JSEG.region_segments_many(crops, masks, n_segs, compactness=10.0, sigma=1.0)
    got = TSEG.region_segments_many(crops, masks, n_segs, CPU, compactness=10.0, sigma=1.0)
    for g, wnt, m in zip(got, want, masks):
        assert g.shape == wnt.shape
        assert g.max() == wnt.max()
        assert np.mean(g[m] == wnt[m]) >= 0.999


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


@pytest.mark.usefixtures("one_thread")
def test_slic_features_match_xla():
    """Lab of 2^20 random colours and the 9-tap blur of Lab, batched as the
    SLIC core runs them, equal XLA's bits (glibc's powf, folded constants,
    Eigen's 3x3 product and convolution order)."""
    from roibasedimagecompression_tpu.ops import colors as JCOL
    from roibasedimagecompression_tpu.ops import conv as JCONV
    from roibasedimagecompression_torch.ops import colors as TCOL
    from roibasedimagecompression_torch.ops import conv as TCONV

    c = np.random.default_rng(3).integers(0, 256, (1 << 20, 3)).astype(np.uint8)
    np.testing.assert_array_equal(TCOL.rgb_to_lab(torch.from_numpy(c)).numpy(),
                                  np.asarray(jax.jit(JCOL.rgb_to_lab)(c)))
    img = np.random.default_rng(4).integers(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    want = jax.jit(jax.vmap(lambda r: JCONV.gaussian_blur(JCOL.rgb_to_lab(r), 1.0)))(img)
    got = TCONV.gaussian_blur(TCOL.rgb_to_lab(torch.from_numpy(img)), 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("slic_mode", [None, "1"], indirect=True, scope="module")
@pytest.mark.parametrize("seed,h,w", [(4, 128, 160), (11, 128, 160), (12, 160, 128)])
def test_slic_matches_jax_both_modes(slic_mode, seed, h, w):
    """SLIC labels of every region equal the JAX package's, in its default
    (expanded) mode and in its Pallas mode."""
    img = synthetic_image(seed, h, w)
    crops, masks = _crops(img, _regions(img)[2])
    n_segs = JSEG.optimal_segments_many(crops, masks)
    want = JSEG.region_segments_many(crops, masks, n_segs, compactness=10.0, sigma=1.0)
    got = TSEG.region_segments_many(crops, masks, n_segs, CPU, compactness=10.0, sigma=1.0)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("slic_mode,seed", [(None, 3), (None, 4), (None, 5), ("0", 3)],
                         indirect=["slic_mode"], scope="module")
def test_default_mode_bytes_equal_jax(slic_mode, seed):
    """synthetic_image seeds 3, 4 and 5 at 128x160 wrote other bytes than the
    JAX default before the port had its distance form, features and centre
    sums; any value of RHCCQ_SLIC_PALLAS but "1" is the default in both."""
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(seed, 128, 160)
    assert TCODEC.encode(img, device="cpu") == rtc.encode(img)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("slic_mode", [None], indirect=True, scope="module")
def test_default_mode_encode_many_equal_jax(slic_mode):
    imgs = [synthetic_image(s, 128, 160) for s in (3, 4, 5)]
    assert TSTREAM.encode_many(imgs, device="cpu") == JSTREAM.encode_many(imgs, jcfg.CodecConfig())
