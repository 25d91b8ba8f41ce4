"""PyTorch port, side modules: contours, the spline codec and its figures,
Zhang-Suen thinning, the bilateral filter and the secondary ROI tools, each
held against the JAX package on the same inputs.  Every result is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roibasedimagecompression_tpu.models import roi_extras as JRX
from roibasedimagecompression_tpu.models import segment as JSEG
from roibasedimagecompression_tpu.models import spline as JSP
from roibasedimagecompression_tpu.models import spline_viz as JSV
from roibasedimagecompression_tpu.ops import bilateral as JBIL
from roibasedimagecompression_tpu.ops import contours as JCONT
from roibasedimagecompression_tpu.ops import thinning as JTHIN
from roibasedimagecompression_torch.models import roi_extras as TRX
from roibasedimagecompression_torch.models import segment as TSEG
from roibasedimagecompression_torch.models import spline as TSP
from roibasedimagecompression_torch.models import spline_viz as TSV
from roibasedimagecompression_torch.ops import bilateral as TBIL
from roibasedimagecompression_torch.ops import contours as TCONT
from roibasedimagecompression_torch.ops import thinning as TTHIN
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test's torch work on one thread and restores the count after:
    the suite runs several worker processes on the host's cores, and a torch
    thread pool per worker only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed, h=48, w=56, p=0.55):
    """A random mask with a few solid blobs and thin bars, from a seed."""
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) > p
    mask[h // 10 : h // 3, w // 9 : w // 3] = True
    mask[h * 5 // 8, 4 : w * 5 // 7] = True
    mask[h // 3 : h - 4, w - 10] = True
    return mask


def _assert_contours_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_contours_match_jax(seed):
    mask = _blobs(seed, 24, 28, 0.6)
    _assert_contours_equal(TCONT.find_contours(mask), JCONT.find_contours(mask))
    square = np.zeros((10, 10), bool)
    square[3:7, 2:8] = True
    _assert_contours_equal(TCONT.find_contours(square), JCONT.find_contours(square))
    seg = np.zeros((12, 12), np.int32)
    seg[2:6, 2:6] = 1
    seg[7:11, 7:11] = 2
    seg[0, 11] = 3
    for s, m in ((seg, seg > 0), (np.random.default_rng(seed).integers(0, 4, (14, 16)), np.ones((14, 16), bool))):
        a, b = TCONT.segment_boundaries(s, m), JCONT.segment_boundaries(s, m)
        assert a == b


def _jagged(n=240, seed=3):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 40 + 6 * np.sin(5 * t) + rng.random(n) * 2
    return np.column_stack([100 + r * np.cos(t), 100 + r * np.sin(t)])


@pytest.mark.parametrize("shape", ["circle", "jagged"])
def test_spline_matches_jax(shape, tmp_path):
    if shape == "circle":
        t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
        coords = np.column_stack([100 + 40 * np.cos(t), 100 + 40 * np.sin(t)])
    else:
        coords = _jagged()
    a = TSP.compress_shape(coords, num_sublists=3, compression_ratio=0.2)
    b = JSP.compress_shape(coords, num_sublists=3, compression_ratio=0.2)
    np.testing.assert_array_equal(a["combined_reconstructed"], b["combined_reconstructed"])
    assert a["overall_metrics"] == b["overall_metrics"]
    for ra, rb in zip(a["sublist_results"], b["sublist_results"]):
        np.testing.assert_array_equal(ra["key_points"], rb["key_points"])
        assert ra["mean_error"] == rb["mean_error"]
    keys = TSP.minimal_storage(a)
    np.testing.assert_array_equal(keys, JSP.minimal_storage(b))
    np.testing.assert_array_equal(TSP.reconstruct_from_minimal(keys, 300),
                                  JSP.reconstruct_from_minimal(keys, 300))
    for name in ("k.npy", "k.csv"):
        TSP.save_key_points(keys, tmp_path / name)
        np.testing.assert_array_equal(TSP.load_key_points(tmp_path / name),
                                      JSP.load_key_points(tmp_path / name))
    assert TSV.compression_analysis(a) == JSV.compression_analysis(b)
    recon = TSP.reconstruct_from_minimal(keys, 400)
    assert TSV.quality_metrics(coords, recon) == JSV.quality_metrics(coords, recon)


def test_spline_viz_figure(tmp_path):
    """One figure of the copied module is drawn (matplotlib is here)."""
    coords = _jagged(160)
    result = TSP.compress_shape(coords, num_sublists=3, compression_ratio=0.25)
    TSV.plot_divided_compression(coords, result, tmp_path / "d.png")
    assert (tmp_path / "d.png").stat().st_size > 5000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thinning_matches_jax(seed):
    mask = _blobs(seed)
    want = np.asarray(JTHIN.zhang_suen_thinning(jnp.asarray(mask)))
    got = TTHIN.zhang_suen_thinning(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    bar = np.zeros((20, 40), bool)
    bar[8:13, 5:35] = True
    np.testing.assert_array_equal(TTHIN.zhang_suen_thinning(torch.from_numpy(bar)).numpy(),
                                  np.asarray(JTHIN.zhang_suen_thinning(jnp.asarray(bar))))


def test_thinning_iteration_cap_matches_jax():
    """The cap counts iterations as the JAX loop does, between checks too."""
    mask = np.ones((40, 44), bool)
    for cap in (1, 3, 5):
        want = np.asarray(JTHIN.zhang_suen_thinning(jnp.asarray(mask), cap))
        np.testing.assert_array_equal(
            TTHIN.zhang_suen_thinning(torch.from_numpy(mask), cap).numpy(), want)


@pytest.mark.parametrize("args", [(9, 50.0, 50.0), (5, 30.0, 30.0), (9, 10.0, 3.0)])
def test_bilateral_matches_jax_exactly(args):
    """Bit for bit: XLA's exp polynomial (`exp32`), its rounding of the
    scales and its fused accumulation."""
    for img in (synthetic_image(3, 40, 48), np.random.default_rng(1).integers(0, 256, (32, 40, 3), np.uint8)):
        want = np.asarray(JBIL.bilateral_filter(jnp.asarray(img), *args))
        got = TBIL.bilateral_filter(torch.from_numpy(img), *args).numpy()
        np.testing.assert_array_equal(got, want)


def test_exp32_is_xla_exp():
    import jax

    x = (np.random.default_rng(2).standard_normal(50_000) * 40).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(TBIL.exp32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("method", ["dilation", "closing", "skeleton", "region_growing", "voronoi"])
def test_connect_strategies_match_jax(method):
    mask = _blobs(4, 40, 44, 0.8)
    want = JRX.connect_nearby_pixels(mask, connection_distance=3, method=method, min_region_size=3)
    got = TRX.connect_nearby_pixels(mask, connection_distance=3, method=method, min_region_size=3, device=CPU)
    np.testing.assert_array_equal(got, want)


def test_thin_structures_v1_and_thinness_match_jax():
    mask = _blobs(5, 48, 56, 0.75)
    np.testing.assert_array_equal(
        TRX.remove_thin_structures_v1(mask, thinness_threshold=0.3, device=CPU),
        JRX.remove_thin_structures_v1(mask, thinness_threshold=0.3))
    for m in (mask, mask[:20, :30]):
        assert TRX.region_thinness_v1(m) == JRX.region_thinness_v1(m)


def test_contextual_cleaning_matches_jax():
    def regions(mod):
        parent = mod.Region(bbox=(0, 0, 40, 40), bbox_mask=np.ones((40, 40), bool), area=1600, kind="roi")
        child = mod.Region(bbox=(10, 10, 14, 14), bbox_mask=np.ones((4, 4), bool), area=16, kind="nonroi")
        big = mod.Region(bbox=(50, 0, 90, 40), bbox_mask=np.ones((40, 40), bool), area=1600, kind="nonroi")
        return [parent], [child, big]

    a = TRX.contextual_region_cleaning(*regions(TSEG))
    b = JRX.contextual_region_cleaning(*regions(JSEG))
    assert [[(r.bbox, r.area, r.kind) for r in side] for side in a] == \
        [[(r.bbox, r.area, r.kind) for r in side] for side in b]
    assert TRX.build_region_hierarchy(regions(TSEG)[0] + regions(TSEG)[1]) == \
        JRX.build_region_hierarchy(regions(JSEG)[0] + regions(JSEG)[1])


@pytest.mark.parametrize("n_segments", [4, 8])
def test_watershed_matches_jax(n_segments):
    img = synthetic_image(6, 40, 48)
    mask = np.zeros((40, 48), bool)
    mask[3:37, 2:20] = True
    mask[4:36, 26:46] = True
    want = JRX.watershed_segments(img, mask, n_segments=n_segments)
    got = TRX.watershed_segments(img, mask, n_segments=n_segments, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[mask])) >= 2
