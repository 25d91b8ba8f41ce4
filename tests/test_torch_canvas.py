"""PyTorch port, the canvas tiers path (RHCCQ_CANVAS_TIERS=1 and
fill_black_holes) and its parts: connected components, unique colours, hole
filling, colour-map clustering and the empty tier-1 table.  Each test runs
the JAX function and the port function (device="cpu") on the same numpy
input made from a seed; bytes and arrays are compared exactly.  The JAX
default's SLIC is held in tests/test_torch_kernels.py and
tests/test_torch_segment.py, the split overrides in tests/test_torch_eval.py.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import holes as JHOLES
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.ops import cc as JCC
from roibasedimagecompression_tpu.ops import unique as JU
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import holes as THOLES
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.ops import cc as TCC
from roibasedimagecompression_torch.ops import unique as TU
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


pytestmark = pytest.mark.usefixtures("one_thread")


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


# ---------------------------------------------------------------------------
# The canvas tiers path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, scope="module")
def test_composed_tiers_match_canvas_path_bytes(slic_mode, monkeypatch):
    """The JAX law of tests/test_codec.py in the port: the canvas path writes
    the composed path's bytes, for encode (one region and full) and for
    encode_many of 2."""
    img = synthetic_image(81, 96, 96)
    other = synthetic_image(82, 96, 96)
    single, full = tcfg.CodecConfig(single_region=True), tcfg.CodecConfig()
    composed = [rtt.encode(img, single, device="cpu"), rtt.encode(img, full, device="cpu"),
                TSTREAM.encode_many([img, other], full, device="cpu")]
    monkeypatch.setenv("RHCCQ_CANVAS_TIERS", "1")
    assert [rtt.encode(img, single, device="cpu"), rtt.encode(img, full, device="cpu"),
            TSTREAM.encode_many([img, other], full, device="cpu")] == composed


def _noisy(seed, h, w, sigma):
    img = synthetic_image(seed, h, w).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, sigma, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _speckled(seed, h=128, w=160):
    """A synthetic image with 40 near-black 2x2 speckles: their tier-1 and
    tier-2 colours truncate to black, which leaves small holes in the tier-2
    canvas (the fixtures' images have none)."""
    img = synthetic_image(seed, h, w)
    rng = np.random.default_rng(seed)
    for y, x in zip(rng.integers(2, h - 4, 40), rng.integers(2, w - 4, 40)):
        img[y: y + 2, x: x + 2] = rng.integers(0, 2, (2, 2, 3))
    return img


def _t2_canvas(img):
    """The port's tier-2 canvas of `img` without hole filling."""
    from roibasedimagecompression_torch.models import roi_fused
    from roibasedimagecompression_torch.ops import canny

    config = tcfg.CodecConfig()
    low, high = canny.select_thresholds_pair(img)
    roi, nonroi = roi_fused.roi_masks_fast(img, config, low, high)
    regs = TCODEC._extract_and_assign(img, roi, nonroi, config, tcfg.min_region_size(img.size))
    seg_map, seg_q, seg_g = TCODEC.build_segment_map(img, *regs, config, CPU)
    t1 = TQB.tier1_colors(img, seg_map, seg_q, CPU, split_method=config.split_method,
                          split_margin=config.split_margin)
    (t2,), _ = TCODEC.tiers23_colors_many([t1], [seg_g[seg_map]], config, CPU)
    return t2


@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, scope="module")
@pytest.mark.parametrize("seed", [83])
def test_fill_black_holes_bytes_equal_jax(slic_mode, seed):
    import roibasedimagecompression_tpu as rtc

    for img in (synthetic_image(seed, 128, 160), _speckled(seed)):
        assert rtt.encode(img, tcfg.CodecConfig(fill_black_holes=10), device="cpu") == rtc.encode(
            img, jcfg.CodecConfig(fill_black_holes=10)
        )


@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, scope="module")
def test_fill_black_holes_changes_the_canvas_and_matches_jax(slic_mode):
    """An image whose tier-2 canvas has holes the fill closes: encode and
    encode_many at fill_black_holes=10 equal JAX, and differ from the
    unfilled encode."""
    import roibasedimagecompression_tpu as rtc

    img = _speckled(62)
    t2 = _t2_canvas(img)
    assert not np.array_equal(THOLES.fill_black_holes(t2, 10), t2)
    fill_t, fill_j = tcfg.CodecConfig(fill_black_holes=10), jcfg.CodecConfig(fill_black_holes=10)
    ours = rtt.encode(img, fill_t, device="cpu")
    assert ours == rtc.encode(img, fill_j)
    assert ours != rtt.encode(img, device="cpu")
    imgs = [img, _speckled(84)]
    assert TSTREAM.encode_many(imgs, fill_t, device="cpu") == JSTREAM.encode_many(imgs, fill_j)


@pytest.mark.parametrize("seed,h,w,p_black,max_hole", [
    (0, 48, 64, 0.15, 10), (1, 64, 64, 0.35, 3), (2, 33, 47, 0.6, 50), (3, 40, 40, 0.0, 10),
])
def test_fill_black_holes_and_parts_match_jax(seed, h, w, p_black, max_hole):
    """Random few-colour canvases with black holes of every size: the hole
    fill (ties to the smaller packed colour), connected components and unique
    colours equal the JAX package's."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(1, 256, (5, 3)).astype(np.uint8)
    canvas = pal[rng.integers(0, 5, (h, w))]
    canvas[rng.random((h, w)) < p_black] = 0
    np.testing.assert_array_equal(THOLES.fill_black_holes(canvas, max_hole),
                                  JHOLES.fill_black_holes(canvas, max_hole))
    black = (canvas == 0).all(-1)
    for conn in (4, 8):
        got, want = TCC.connected_components(black, conn), JCC.connected_components(black, conn)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    gp, gi = TU.unique_colors(canvas.reshape(-1, 3))
    wp, wi = JU.unique_colors(canvas.reshape(-1, 3))
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int32


@pytest.mark.parametrize("weighted,split", [(True, "hybrid"), (False, "kmeans"), (True, "mediancut")])
def test_cluster_color_maps_many_matches_jax(weighted, split):
    """Three problems on two canvases (one canvas twice), painted in place,
    equal the JAX package's."""
    rng = np.random.default_rng(5)
    canvases = [rng.integers(0, 256, (40, 56, 3)).astype(np.uint8) for _ in range(2)]
    canvases[1][::3] = 0
    sels = [rng.random((40, 56)) < 0.6, rng.random((40, 56)) < 0.5, np.ones((40, 56), bool)]
    colors = [canvases[0], canvases[0], canvases[1]]
    quals = [60.0, 30.0, 45.0]
    kw = dict(seed=42, weighted=weighted, split_method=split, split_margin=1.5)
    outs_t = [np.zeros_like(c) for c in canvases]
    outs_j = [np.zeros_like(c) for c in canvases]
    TQB.cluster_color_maps_many(colors, sels, quals, [outs_t[0], outs_t[0], outs_t[1]], CPU, **kw)
    JQB.cluster_color_maps_many(colors, sels, quals, out_list=[outs_j[0], outs_j[0], outs_j[1]], **kw)
    for g, wnt in zip(outs_t, outs_j):
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, scope="module")
def test_tier1_colors_and_tiers23_colors_match_jax(slic_mode):
    img = _noisy(85, 96, 128, 10.0)
    config = jcfg.CodecConfig()
    from roibasedimagecompression_tpu.models import roi_fused as JROI
    from roibasedimagecompression_tpu.ops import canny as JCANNY

    low, high = JCANNY.select_thresholds_pair(img)
    roi, nonroi = JROI.roi_masks_fast(img, config, low, high)
    regs = JCODEC._extract_and_assign(img, roi, nonroi, config, jcfg.min_region_size(img.size))
    seg_map, seg_q, seg_g = JCODEC.build_segment_map(img, *regs, config)
    jt1 = JQB.tier1_colors(img, seg_map, seg_q, seed=42, split_method="hybrid", split_margin=1.5)
    tt1 = TQB.tier1_colors(img, seg_map, seg_q, CPU, seed=42, split_method="hybrid", split_margin=1.5)
    np.testing.assert_array_equal(tt1, jt1)
    for fill in (0, 10):
        jc = jcfg.CodecConfig(fill_black_holes=fill)
        j2, j3 = JCODEC.tiers23_colors_many([jt1], [seg_g[seg_map]], jc)
        t2, t3 = TCODEC.tiers23_colors_many([tt1], [seg_g[seg_map]], tcfg.from_dict(dataclasses.asdict(jc)), CPU)
        np.testing.assert_array_equal(t2[0], j2[0])
        np.testing.assert_array_equal(t3[0], j3[0])


@pytest.mark.parametrize("fill", [0, 10])
def test_empty_tier1_table_matches_jax(fill):
    """No image of the fixtures gives an empty tier-1 table (every pixel of
    these lies in a segment), so the canvas finish takes one directly: a
    batch without segments writes the JAX package's bytes."""
    rng = np.random.default_rng(9)
    batch = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    tall_seg = np.zeros((64, 48), np.int32)
    seg_group = np.zeros(1, np.int32)
    jc = jcfg.CodecConfig(fill_black_holes=fill)
    want = JSTREAM._finish_canvas_path(None, tall_seg, seg_group, batch, jc, None)
    got = TSTREAM._finish_canvas_path(None, tall_seg, seg_group, batch,
                                      tcfg.from_dict(dataclasses.asdict(jc)), CPU)
    assert got == want
    assert all(rtt.unpack(d).n_colors == 1 for d in got)
