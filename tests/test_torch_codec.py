"""PyTorch port, codec: tier 1 through the container on the JAX package's own
segment map (bytes equal), the whole encode against the JAX encode, decode,
and (with a card) the CUDA encode against the CPU encode."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.io import container as JC
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.models import refine as JRF
from roibasedimagecompression_tpu.models import roi_fused as JROI
from roibasedimagecompression_tpu.ops import canny as JCANNY
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch.io import container as TC
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.models import refine as TRF
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


def _noisy(seed, h=128, w=160, sigma=14.0):
    """A synthetic image with strong noise: large per-segment palettes, so
    the oversized-cluster splits (median cuts and device k-means) run."""
    img = synthetic_image(seed, h, w).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, sigma, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _jax_seg(img, config):
    low, high = JCANNY.select_thresholds_pair(img)
    roi, nonroi = JROI.roi_masks_fast(img, config, low, high)
    regs = JCODEC._extract_and_assign(img, roi, nonroi, config, jcfg.min_region_size(img.size))
    return JCODEC.build_segment_map(img, *regs, config)


@pytest.mark.parametrize(
    "image,overrides",
    [
        ((21, 128, 160, 0.0), {}),
        ((22, 128, 160, 14.0), {}),
        ((23, 96, 128, 20.0), {"split_method": "kmeans"}),
        ((24, 128, 160, 14.0), {"roi_quality": 40.0, "nonroi_quality": 25.0, "weighted_palette": False}),
    ],
)
def test_tier1_to_container_on_jax_segmap(image, overrides):
    seed, h, w, sigma = image
    img = _noisy(seed, h, w, sigma) if sigma else synthetic_image(seed, h, w)
    jconfig = jcfg.CodecConfig(**overrides)
    tconfig = tcfg.from_dict(dataclasses.asdict(jconfig))
    seg_map, seg_q, seg_g = _jax_seg(img, jconfig)
    kw = dict(seed=jconfig.seed, weighted=jconfig.weighted_palette,
              split_method=jconfig.split_method, split_margin=jconfig.split_margin)
    jt = JQB.tier1_table(img, seg_map, seg_q, weighted_split=False, **kw)
    tt = TQB.tier1_table(img, seg_map, seg_q, CPU, **kw)
    np.testing.assert_array_equal(tt["cluster_of_pair"], jt["cluster_of_pair"])
    np.testing.assert_array_equal(tt["cluster_colors"], jt["cluster_colors"])
    image_of_seg = np.zeros(len(seg_q), np.int32)
    ((jp, ji),) = JCODEC.tiers23_palette_indices(jt, seg_g, image_of_seg, 1, (h, w), jconfig)
    ((tp, ti),) = TCODEC.tiers23_palette_indices(tt, seg_g, image_of_seg, 1, (h, w), tconfig, CPU)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)
    jp = JRF.maybe_refit(img, jp, ji, jconfig)
    tp = TRF.maybe_refit(img, tp, ti, tconfig)
    assert TC.pack(tp, ti, level=tconfig.container_level) == JC.pack(
        jp, ji, level=jconfig.container_level
    )


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse)


def _assert_same_encode(img, a, b, seg_a, seg_b):
    """Bytes equal where the segment maps are equal; otherwise the segment
    maps agree on >= 99.5 % of pixels, PSNR within 0.05 dB, size within 1 %."""
    if a == b:
        return
    sa, sb = seg_a(), seg_b()
    assert not np.array_equal(sa, sb), "equal segment maps but different bytes"
    assert np.mean(sa == sb) >= 0.995
    assert abs(_psnr(img, rtt.decode(a)) - _psnr(img, rtt.decode(b))) <= 0.05
    assert abs(len(a) - len(b)) <= 0.01 * len(b)


def _torch_seg(img, device):
    config = tcfg.CodecConfig()
    from roibasedimagecompression_torch.models import roi_fused
    from roibasedimagecompression_torch.ops import canny

    low, high = canny.select_thresholds_pair(img)
    roi, nonroi = roi_fused.roi_masks_fast(img, config, low, high)
    regs = TCODEC._extract_and_assign(img, roi, nonroi, config, tcfg.min_region_size(img.size))
    return TCODEC.build_segment_map(img, *regs, config, device)[0]


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
@pytest.mark.parametrize("slic_mode", ["1", None], indirect=True, ids=["pallas", "default"], scope="module")
@pytest.mark.parametrize("seed,h,w", [(31, 128, 160), (32, 160, 128), (33, 112, 144)])
def test_whole_encode_matches_jax(slic_mode, seed, h, w):
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(seed, h, w)
    ours = rtt.encode(img, device="cpu")
    theirs = rtc.encode(img)
    _assert_same_encode(
        img, ours, theirs, lambda: _torch_seg(img, CPU), lambda: _jax_seg(img, jcfg.CodecConfig())[0]
    )
    out = rtt.decode(ours)
    assert out.shape == img.shape and _psnr(img, out) > 28.0


def test_decode_matches_jax_both_ways():
    import roibasedimagecompression_tpu as rtc

    img = _noisy(41, 96, 128, 8.0)
    ours = rtt.encode(img, device="cpu")
    theirs = JC.pack(*_coarse_palette_indices(img), level=0)
    for data in (ours, theirs):
        np.testing.assert_array_equal(rtt.decode(data), rtc.decode(data))
        assert rtt.unpack(data).n_colors == JC.unpack(data).n_colors


def _coarse_palette_indices(img):
    """A JAX-written palette/index pair without running the JAX encode: the
    unique colours of a coarsely quantised image."""
    q = (img // 16) * 16
    flat = q.reshape(-1, 3)
    pal, inv = np.unique(flat, axis=0, return_inverse=True)
    return pal.astype(np.uint8), inv.reshape(img.shape[:2]).astype(np.uint16)


def test_unported_options_raise(monkeypatch):
    """No CodecConfig field raises any more: region fusion and the weighted
    split (ROADMAP A12c) encode, on both paths, to the JAX package's bytes."""
    import roibasedimagecompression_tpu as rtc

    img = synthetic_image(1, 64, 64)
    for kw in (dict(region_fusion=True), dict(weighted_split=True),
               dict(batched=False, region_fusion=True), dict(batched=False, weighted_split=True)):
        assert rtt.encode(img, tcfg.CodecConfig(**kw), device="cpu") == rtc.encode(
            img, jcfg.CodecConfig(**kw))
    # batched=False, the reference-shaped loop, is ported: it encodes.
    loop = rtt.encode(img, tcfg.CodecConfig(batched=False), device="cpu")
    assert rtt.decode(loop).shape == img.shape
    # fill_black_holes and the canvas tiers path are ported: they encode.
    filled = rtt.encode(img, tcfg.CodecConfig(fill_black_holes=50), device="cpu")
    assert rtt.decode(filled).shape == img.shape
    monkeypatch.setenv("RHCCQ_CANVAS_TIERS", "1")
    assert rtt.encode(img, device="cpu") == rtt.encode(img, tcfg.CodecConfig(), device="cpu")
    monkeypatch.delenv("RHCCQ_CANVAS_TIERS")
    assert rtt.decode(rtt.encode(img, device="cpu")).shape == img.shape
    # fast_edges is ported: it encodes, and to other bytes than the sweep.
    fast = rtt.encode(img, tcfg.CodecConfig(fast_edges=True), device="cpu")
    assert rtt.decode(fast).shape == img.shape


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [51, 52])
def test_cuda_encode_matches_cpu(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from roibasedimagecompression_torch.ops.cuda import _build

    img = _noisy(seed, 256, 320, 10.0)
    s0, e0 = _build.launched["slic_assign"].total(), _build.launched["epscc"].total()
    gpu = rtt.encode(img)
    assert _build.launched["slic_assign"].total() > s0 and _build.launched["epscc"].total() > e0
    cpu = rtt.encode(img, device="cpu")
    _assert_same_encode(
        img, gpu, cpu, lambda: _torch_seg(img, torch.device("cuda")), lambda: _torch_seg(img, CPU)
    )


@pytest.mark.parametrize("slic_mode", ["1"], indirect=True, ids=["pallas"], scope="module")
@pytest.mark.parametrize("case", ["gray", "black", "halves", "grayscale_2d", "tiny"])
def test_edge_images_match_jax(slic_mode, case):
    """Flat, all-black, two-tone, 2-D grayscale and tiny inputs."""
    import roibasedimagecompression_tpu as rtc

    img = {
        "gray": np.full((64, 64, 3), 128, np.uint8),
        "black": np.zeros((64, 64, 3), np.uint8),
        "halves": np.concatenate(
            [np.zeros((32, 64, 3), np.uint8), np.full((32, 64, 3), 200, np.uint8)]
        ),
        "grayscale_2d": (np.arange(48 * 64).reshape(48, 64) % 256).astype(np.uint8),
        "tiny": np.random.default_rng(0).integers(0, 256, (9, 7, 3)).astype(np.uint8),
    }[case]
    assert rtt.encode(img, device="cpu") == rtc.encode(img)
