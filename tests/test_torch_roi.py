"""PyTorch port, the ROI frontend of the reference-shaped loop
(`models/roi.py roi_masks`): XLA's box-filter bits, morphology, the distance
transform, the border mask, the edge map, the masks, and the loop's bytes
with ROI and non-ROI regions, each against the JAX package on the same
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import roi as JROI
from roibasedimagecompression_tpu.ops import canny as JCANNY
from roibasedimagecompression_tpu.ops import conv as JCONV
from roibasedimagecompression_tpu.ops import distance as JDIST
from roibasedimagecompression_tpu.ops import morphology as JM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import roi as TROI
from roibasedimagecompression_torch.ops import canny as TCANNY
from roibasedimagecompression_torch.ops import cc as TCC
from roibasedimagecompression_torch.ops import conv as TCONV
from roibasedimagecompression_torch.ops import distance as TDIST
from roibasedimagecompression_torch.ops import hist as THIST
from roibasedimagecompression_torch.ops import morphology as TM
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


# Fixtures whose ROI masks give both ROI and non-ROI regions (7, 12, 18),
# and one whose ROI mask is empty (100).
MIXED = (7, 12, 18)


def _edges(seed, h=128, w=160):
    return JCANNY.get_edge_map(synthetic_image(seed, h, w))[0]


def _window_counts(x, k):
    """Integer count of ones in each k x k window, reflect borders."""
    r = k // 2
    p = np.pad(x.astype(np.int64), r, mode="reflect")
    c = np.zeros(x.shape, np.int64)
    for dy in range(k):
        for dx in range(k):
            c += p[dy : dy + x.shape[0], dx : dx + x.shape[1]]
    return c


@pytest.mark.parametrize("k", [3, 15, 25])
def test_box_density_matches_xla_bits(k):
    """XLA's CPU convolution bits, on the fixtures' edge maps and on random
    binaries of densities 0.1-0.3 and several shapes (odd pixel counts take
    Eigen's scalar tail), with windows sitting exactly on the thresholds
    0.2 * 225 = 45 and 0.2 * 625 = 125."""
    rng = np.random.default_rng(k)
    maps = [_edges(7), _edges(100)]
    maps += [rng.random(s) < d for s, d in (((128, 160), 0.1), ((97, 131), 0.2),
                                             ((128, 160), 0.2), ((33, 37), 0.3), ((9, 7), 0.3))]
    on_threshold = 0
    for x in maps:
        want = np.asarray(JCONV.box_density(jnp.asarray(x), k))
        got = TCONV.box_density(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        if k in (15, 25):
            on_threshold += int((_window_counts(x, k) == k * k // 5).sum())
    if k in (15, 25):
        assert on_threshold > 100


def test_reach_and_morphology_match_jax():
    """The gap-bridging reach maps (> 0), closing with cv2's ellipse, 3 x 3
    dilation and erosion, and scipy's cross dilation."""
    x = _edges(12)
    t = torch.from_numpy(x)
    kernels = JCONV.directional_reach_kernels(25, 15)
    np.testing.assert_array_equal(TCONV.directional_reach_kernels(25, 15), kernels)
    want = np.asarray(JCONV.conv2d_same_multi(jnp.asarray(x, jnp.float32) * 255.0,
                                              jnp.asarray(kernels)) > 0)
    np.testing.assert_array_equal(TCONV.conv2d_same_multi(t.float() * 255.0, kernels).numpy(), want)
    for k in (3, 11):
        np.testing.assert_array_equal(TM.ellipse_kernel(k), JM.ellipse_kernel(k))
    se = JM.ellipse_kernel(11)
    np.testing.assert_array_equal(TM.close(t, se).numpy(), np.asarray(JM.close(jnp.asarray(x), se)))
    np.testing.assert_array_equal(TM.open_(t, se).numpy(), np.asarray(JM.open_(jnp.asarray(x), se)))
    ones3 = np.ones((3, 3), bool)
    np.testing.assert_array_equal(TM.dilate(t, ones3, 2).numpy(),
                                  np.asarray(JM.dilate(jnp.asarray(x), ones3, 2)))
    np.testing.assert_array_equal(TM.erode(t, ones3).numpy(), np.asarray(JM.erode(jnp.asarray(x), ones3)))
    np.testing.assert_array_equal(TM.binary_dilation_scipy(t, 3).numpy(),
                                  np.asarray(JM.binary_dilation_scipy(jnp.asarray(x), iterations=3)))


def test_distance_transform_matches_jax():
    rng = np.random.default_rng(3)
    blobs = TM.dilate(torch.from_numpy(rng.random((96, 128)) < 0.01), TM.ellipse_kernel(15)).numpy()
    for fg in (blobs, ~blobs, _edges(7), np.ones((20, 30), bool)):
        want = np.asarray(JDIST.distance_transform_l2(jnp.asarray(fg)))
        got = TDIST.distance_transform_l2(torch.from_numpy(fg)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_component_stages_match_jax():
    """The host stages: thin structures, noise, holes, small regions, and
    the border mask."""
    rc = jcfg.RoiConfig()
    x = _edges(18)
    closed = np.asarray(JM.close(jnp.asarray(x), JM.ellipse_kernel(11)))
    np.testing.assert_array_equal(
        TROI.remove_thin_structures(x, 0.1, 0.3, 25, 10, CPU),
        JROI.remove_thin_structures(x, 0.1, 0.3, 25, 10))
    np.testing.assert_array_equal(
        TROI.remove_small_noise_regions(x, 75, 0.2, 15, CPU),
        JROI.remove_small_noise_regions(x, 75, 0.2, 15))
    np.testing.assert_array_equal(TROI.fill_closed_regions(closed, 10, 10_000, 4),
                                  JROI.fill_closed_regions(closed, 10, 10_000, 4))
    np.testing.assert_array_equal(TROI.remove_small_regions(x, 5, CPU), JROI.remove_small_regions(x, 5))
    for b in (x, closed):
        border = JROI.detect_meaningful_borders(b, rc.border_sensitivity)
        np.testing.assert_array_equal(TROI.detect_meaningful_borders(b, rc.border_sensitivity, CPU), border)
        np.testing.assert_array_equal(TROI.protect_border_regions(b, border, 15, CPU),
                                      JROI.protect_border_regions(b, border, 15))
        np.testing.assert_array_equal(TROI.bridge_small_gaps(b, 100, 0.2, 15, 25, CPU),
                                      JROI.bridge_small_gaps(b, 100, 0.2, 15, 25))
    labels, num = TCC.connected_components(x)
    stats = TCC.component_stats(labels, num)
    assert stats.areas[1:].sum() == x.sum()
    dens = TCONV.box_density(torch.from_numpy(x), 3)
    assert abs(float(THIST.masked_mean(dens, torch.from_numpy(x)))
               - float(dens.numpy()[x].mean())) < 1e-6


@pytest.mark.parametrize("seed", (100,) + MIXED)
def test_edge_map_and_roi_masks_match_jax(seed):
    img = synthetic_image(seed, 128, 160)
    t_edges, t_pair = TCANNY.get_edge_map(img)
    j_edges, j_pair = JCANNY.get_edge_map(img)
    assert t_pair == j_pair
    np.testing.assert_array_equal(t_edges, j_edges)
    t_roi, t_non = TROI.roi_masks(img, tcfg.CodecConfig(), CPU)
    j_roi, j_non = JROI.roi_masks(img, jcfg.CodecConfig())
    np.testing.assert_array_equal(t_roi, j_roi)
    np.testing.assert_array_equal(t_non, j_non)


@pytest.mark.parametrize("seed", MIXED)
def test_loop_bytes_match_jax(seed):
    """`encode(..., CodecConfig(batched=False))` on images whose masks give
    ROI and non-ROI regions."""
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(seed, 128, 160)
    config = tcfg.CodecConfig(batched=False)
    roi, nonroi = TROI.roi_masks(img, config, CPU)
    regs = TCODEC._extract_and_assign(img, roi, nonroi, config, tcfg.min_region_size(img.size))
    assert len(regs[0]) > 0 and len(regs[1]) > 0
    ours = rtt.encode(img, config, device="cpu")
    assert ours == rtc.encode(img, jcfg.CodecConfig(batched=False))
    assert rtt.decode(ours).shape == img.shape


def test_loop_without_native_runtime_raises_a13(monkeypatch):
    """A runtime that fails to load raises: the port never slides onto the
    device branches by itself.  Under RHCCQ_NATIVE=0 the same calls run
    those branches (ROADMAP A13), and the loop writes the JAX package's
    bytes without its runtime."""
    import roibasedimagecompression_tpu as rtc
    from roibasedimagecompression_tpu import native as jnative

    def unavailable():
        raise OSError("no runtime")

    img = synthetic_image(7, 64, 80)
    calls = (lambda: TCANNY.get_edge_map(img),
             lambda: TCC.connected_components(np.ones((4, 4), bool)),
             lambda: rtt.encode(img, tcfg.CodecConfig(batched=False), device="cpu"))
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", unavailable)
        for fn in calls:
            with pytest.raises(OSError, match="no runtime"):
                fn()
    monkeypatch.setattr(native, "_off", True)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert TCANNY.hysteresis_host(np.ones((4, 4), np.float32), np.ones((4, 4), bool), 1, 2) is None
    edges, pair = calls[0]()
    assert edges.shape == img.shape[:2] and pair == JCANNY.get_edge_map(img)[1]
    labels, num = calls[1]()
    assert num == 2 and (labels == 1).all()
    assert calls[2]() == rtc.encode(img, jcfg.CodecConfig(batched=False))


@pytest.mark.cuda
def test_cuda_box_density_and_masks_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _edges(12)
    for k in (3, 15, 25):
        gpu = TCONV.box_density(torch.from_numpy(x).cuda(), k).cpu().numpy()
        cpu = TCONV.box_density(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(gpu.view(np.uint32), cpu.view(np.uint32))
    img = synthetic_image(12, 128, 160)
    for a, b in zip(TROI.roi_masks(img, tcfg.CodecConfig(), torch.device("cuda")),
                    TROI.roi_masks(img, tcfg.CodecConfig(), CPU)):
        np.testing.assert_array_equal(a, b)
