"""PyTorch port without the native runtime (RHCCQ_NATIVE=0, ROADMAP A13):
the switch and its policy, device connected components, device Canny and
threshold selection, the fused ROI mask graph, SLIC's device connectivity,
the device sort-unique, the eps backend pick, the bytes of every entry point
and `encode_debug`, each against the JAX package on the same seeded inputs
with its runtime patched away (`native.get_lib` returning None)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
import roibasedimagecompression_tpu as rtc
from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu import native as jnative
from roibasedimagecompression_tpu.models import codec as JCODEC
from roibasedimagecompression_tpu.models import quantize_batched as JQB
from roibasedimagecompression_tpu.models import roi_fused as JRF
from roibasedimagecompression_tpu.models import segment as JSEG
from roibasedimagecompression_tpu.ops import canny as JCANNY
from roibasedimagecompression_tpu.ops import cc as JCC
from roibasedimagecompression_tpu.ops import colors as JCOL
from roibasedimagecompression_tpu.ops import unique as JU
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.models import codec as TCODEC
from roibasedimagecompression_torch.models import quantize_batched as TQB
from roibasedimagecompression_torch.models import roi_fused as TRF
from roibasedimagecompression_torch.models import segment as TSEG
from roibasedimagecompression_torch.ops import canny as TCANNY
from roibasedimagecompression_torch.ops import cc as TCC
from roibasedimagecompression_torch.ops import colors as TCOL
from roibasedimagecompression_torch.ops import unique as TU
from roibasedimagecompression_torch.parallel import stream as TSTREAM
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

CPU = torch.device("cpu")
# Fixtures with ROI and non-ROI regions (7, 12, 18) and one whose ROI
# mask is the whole image at its thresholds (100).
SEEDS = (7, 12, 18, 100)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's torch work on one thread: the suite runs several worker
    processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def no_runtime(monkeypatch):
    """Both packages without their runtime for the test: the port's switch
    set as RHCCQ_NATIVE=0 sets it, the JAX package's `get_lib` returning
    None."""
    monkeypatch.setattr(native, "_off", True)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


# ---------------------------------------------------------------------------
# The switch.
# ---------------------------------------------------------------------------


def test_switch_is_read_once_and_a_failing_runtime_raises(monkeypatch):
    monkeypatch.setattr(native, "_off", None)
    monkeypatch.setenv("RHCCQ_NATIVE", "0")
    assert not native.available() and native.get_lib() is None
    monkeypatch.delenv("RHCCQ_NATIVE")
    assert not native.available()  # read once per process
    monkeypatch.setattr(native, "_off", None)
    assert native.available()

    # Without the switch a runtime that fails to build raises; the port
    # never slides onto the branches without it by itself.
    def broken():
        raise RuntimeError("building the native runtime failed")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="failed"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="failed"):
        TCC.connected_components(np.ones((3, 3), bool))


def test_wrappers_without_the_runtime(monkeypatch):
    """Every wrapper returns None (the paints False), or runs the JAX
    package's numpy branch, which gives the runtime's result."""
    rng = np.random.default_rng(3)
    idx = np.repeat(rng.integers(0, 5, 300), rng.integers(1, 300, 300)).astype(np.uint16)
    keys = rng.integers(0, 50, 2000).astype(np.int64)
    starts, sizes = np.array([0, 7, 40]), np.array([3, 0, 9])
    with_lib = (native.rle_encode(idx), native.argsort_i64(keys),
                native.unique_inverse_i64(keys, True), native.runs_of_sorted_i64(np.sort(keys)),
                native.flat_run_positions(starts, sizes))
    monkeypatch.setattr(native, "_off", True)
    without = (native.rle_encode(idx), native.argsort_i64(keys),
               native.unique_inverse_i64(keys, True), native.runs_of_sorted_i64(np.sort(keys)),
               native.flat_run_positions(starts, sizes))
    for a, b in zip(with_lib, without):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(native.rle_decode(without[0], idx.size), idx)
    img = synthetic_image(1, 16, 16)
    m = np.ones((16, 16), bool)
    assert native.cc_label(m) is None and native.pack_pairs(img, m.astype(np.int32)) is None
    assert native.roi_pipeline(img, 1, 2, tcfg.RoiConfig()) is None
    assert native.slic_enforce(m.astype(np.int32), m, 1) is None
    assert native.paint_masked_colors(img[0], None, np.zeros(256, np.int64), m, img.copy()) is False


# ---------------------------------------------------------------------------
# Device connected components (ops/cc.py).
# ---------------------------------------------------------------------------


def _snake(h, w):
    """A one-pixel path that winds through every row (JAX
    tests/test_ops_parity.py's long snake)."""
    s = np.zeros((h, w), bool)
    s[::2, :] = True
    for r in range(1, h, 2):
        s[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return s


@pytest.mark.parametrize("connectivity", [4, 8])
def test_propagation_matches_jax(connectivity):
    """Labels, keys (some offset by -2^30, as hysteresis offsets them) and
    equal-value fragments are exact, on random masks, a long snake and a
    full mask."""
    rng = np.random.default_rng(connectivity)
    masks = [rng.random((64, 80)) < d for d in (0.4, 0.6)] + [_snake(40, 41), np.ones((9, 7), bool)]
    for m in masks:
        ids = np.arange(m.size, dtype=np.int32).reshape(m.shape)
        keys = np.where(rng.random(m.shape) < 0.05, ids - (1 << 30), ids).astype(np.int32)
        vals = rng.integers(0, 3, m.shape).astype(np.int32)
        tm, tk, tv = (torch.from_numpy(a) for a in (m, keys, vals))
        np.testing.assert_array_equal(
            TCC.propagate_labels(tm, connectivity).numpy(),
            np.asarray(JCC.propagate_labels(jnp.asarray(m), connectivity)))
        np.testing.assert_array_equal(
            TCC.propagate_keys(tk, tm, connectivity).numpy(),
            np.asarray(JCC.propagate_keys(jnp.asarray(keys), jnp.asarray(m), connectivity)))
        np.testing.assert_array_equal(
            TCC.propagate_equal_labels(tv, tm, connectivity).numpy(),
            np.asarray(JCC.propagate_equal_labels(jnp.asarray(vals), jnp.asarray(m), connectivity)))
    lab = rng.integers(0, 9, (64, 80)).astype(np.int32)
    keep = rng.random((64, 80)) < 0.03
    mask = rng.random((64, 80)) < 0.8
    np.testing.assert_array_equal(
        TCC.adopt_labels(*(torch.from_numpy(a) for a in (lab, keep, mask))).numpy(),
        np.asarray(JCC.adopt_labels(jnp.asarray(lab), jnp.asarray(keep), jnp.asarray(mask))))


def test_connected_components_and_stats_match_jax(no_runtime):
    rng = np.random.default_rng(11)
    for m in (rng.random((61, 77)) < 0.5, _snake(30, 33), np.zeros((5, 5), bool)):
        for conn in (4, 8):
            labels, num = TCC.connected_components(m, conn)
            want, jnum = JCC.connected_components(m, conn)
            assert num == jnum
            np.testing.assert_array_equal(labels, want)
            ours, theirs = TCC.component_stats(labels, num), JCC.component_stats(want, jnum)
            np.testing.assert_array_equal(ours.areas, theirs.areas)
            np.testing.assert_array_equal(ours.bboxes, theirs.bboxes)


# ---------------------------------------------------------------------------
# Device Canny and threshold selection (ops/canny.py).
# ---------------------------------------------------------------------------


def test_gradient_hysteresis_and_canny_match_jax():
    for seed in SEEDS[:3]:
        img = synthetic_image(seed, 96, 128)
        gray = np.asarray(JCOL.rgb_to_gray_cv2(jnp.asarray(img)))
        for image, rgb in ((img, True), (gray, False)):
            mag, nms = TCANNY.gradient_and_nms(torch.from_numpy(np.array(image)), rgb=rgb)
            jmag, jnms = JCANNY.gradient_and_nms(jnp.asarray(image))
            np.testing.assert_array_equal(mag.numpy(), np.asarray(jmag))
            np.testing.assert_array_equal(nms.numpy(), np.asarray(jnms))
        for low, high in ((20.0, 60.0), (41.0, 97.0)):
            np.testing.assert_array_equal(
                TCANNY.hysteresis(mag, nms, low, high).numpy(),
                np.asarray(JCANNY.hysteresis(jmag, jnms, jnp.float32(low), jnp.float32(high))))
            np.testing.assert_array_equal(
                TCANNY.canny(torch.from_numpy(img), low, high).numpy(),
                np.asarray(JCANNY.canny(jnp.asarray(img), low, high)))


@pytest.fixture(scope="module")
def threshold_case():
    imgs = np.stack([synthetic_image(s, 96, 128) for s in SEEDS + (3, 5)])
    gray, cands, _, _ = (np.asarray(a) for a in JCANNY.edge_analysis_batch(jnp.asarray(imgs)))
    scores = [np.asarray(JCANNY.edge_quality_scores(jnp.asarray(g), jnp.asarray(c)))
              for g, c in zip(gray, cands)]
    return imgs, gray, cands, scores


def test_adaptive_thresholds_match_jax(threshold_case):
    imgs, gray, cands, _ = threshold_case
    tgray = TCOL.rgb_to_gray_cv2(torch.from_numpy(imgs))
    np.testing.assert_array_equal(tgray.numpy(), gray)
    np.testing.assert_array_equal(TCANNY.adaptive_thresholds(tgray).numpy(), cands)


def test_edge_quality_scores_match_jax(threshold_case):
    """The scores agree to float32 rounding of their sums (the port adds in
    float64); the chosen candidate, the first best, is the same."""
    imgs, gray, cands, scores = threshold_case
    for g, c, want in zip(gray, cands, scores):
        got = TCANNY.edge_quality_scores(torch.from_numpy(np.array(g)), torch.from_numpy(np.array(c))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        assert int(np.argmax(got)) == int(np.argmax(want))


def test_select_thresholds_match_jax(no_runtime, threshold_case):
    imgs = threshold_case[0]
    lows, highs = TCANNY.select_thresholds_many(imgs, CPU)
    jlows, jhighs = JCANNY.select_thresholds_many(imgs)
    np.testing.assert_array_equal(lows, jlows)
    np.testing.assert_array_equal(highs, jhighs)
    for img in imgs[:2]:
        assert TCANNY.select_thresholds_pair(img, CPU) == JCANNY.select_thresholds_pair(img)
        ours, theirs = TCANNY.get_edge_map(img, CPU), JCANNY.get_edge_map(img)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]


# ---------------------------------------------------------------------------
# The fused ROI mask graph (models/roi_fused.py).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(96, 128), (128, 160)])
def test_roi_masks_device_matches_jax(h, w):
    """Mask equality with the JAX graph, at the fixtures' own thresholds and
    at fixed ones; the fixtures give ROI and non-ROI pixels both."""
    mixed = 0
    for seed in SEEDS:
        img = synthetic_image(seed, h, w)
        for low, high in (JCANNY.select_thresholds_pair(img), (40.0, 90.0)):
            want = JRF.roi_masks_device(jnp.asarray(img), jcfg.RoiConfig(),
                                        jnp.float32(low), jnp.float32(high))
            got = TRF.roi_masks_device(torch.from_numpy(img), tcfg.RoiConfig(), low, high)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            mixed += 0 < float(got[0].float().mean()) < 1
    assert mixed >= 1


# ---------------------------------------------------------------------------
# SLIC's device connectivity, the device sort-unique, the eps backend pick.
# ---------------------------------------------------------------------------


def test_slic_device_connectivity_matches_jax(no_runtime):
    """The device fragments, np.unique compaction, keep law and jump-flood
    adoption: the JAX package's labels without its runtime, which differ
    from the runtime's `slic_enforce` on these fixtures."""
    differs = 0
    for seed in (7, 12, 100):
        img = synthetic_image(seed, 96, 128)
        mask = np.ones(img.shape[:2], bool)
        mask[:20, :30] = False
        for n_seg in (9, 40):
            got = TSEG.region_segments(img, mask, n_seg, CPU)
            np.testing.assert_array_equal(got, JSEG.region_segments(img, mask, n_seg))
            with pytest.MonkeyPatch.context() as m:
                m.setattr(native, "_off", False)
                differs += not np.array_equal(got, TSEG.region_segments(img, mask, n_seg, CPU))
    assert differs


def test_unique_colors_device_matches_jax(no_runtime):
    rng = np.random.default_rng(5)
    for n in (1, 70, 3000):
        px = (rng.integers(0, 4, (n, 3)) * 60).astype(np.uint8)
        pal, idx = TU.unique_colors(px, CPU)
        jpal, jidx = JU.unique_colors(px)
        np.testing.assert_array_equal(pal, jpal)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(pal[idx], px)


@pytest.mark.parametrize("env", [None, "device", "native"])
@pytest.mark.parametrize("runtime", [True, False])
def test_eps_backend_pick(monkeypatch, env, runtime):
    """RHCCQ_EPSCC and the runtime pick the CPU's eps backend as the JAX
    package picks it, and every pick gives the same tier-1 table."""
    if env is not None:
        monkeypatch.setenv("RHCCQ_EPSCC", env)
    monkeypatch.setattr(native, "_off", not runtime)
    if not runtime:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert TQB._epscc_native_on() == JQB._epscc_native_on()
    img = synthetic_image(12, 64, 80)
    seg = (np.arange(64 * 80).reshape(64, 80) // 700 + 1).astype(np.int32)
    q = np.full(seg.max() + 1, 20.0)
    got = TQB.tier1_table(img, seg, q, CPU)
    if env == "native" and not runtime:
        # The JAX package fails here (its union-find returns None); the
        # port takes the sweeps, whose labels are the runtime's.
        monkeypatch.delenv("RHCCQ_EPSCC")
    want = JQB.tier1_table(img, seg, q)
    np.testing.assert_array_equal(got["cluster_of_pair"], want["cluster_of_pair"])
    np.testing.assert_array_equal(got["cluster_colors"], want["cluster_colors"])


# ---------------------------------------------------------------------------
# Bytes and encode_debug.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False], ids=["encode", "loop"])
@pytest.mark.parametrize("seed", [7, 12, 100])
def test_bytes_without_runtime_match_jax(no_runtime, seed, batched):
    img = synthetic_image(seed, 96, 128)
    config = dict(batched=batched)
    assert rtt.encode(img, tcfg.CodecConfig(**config), device="cpu") == rtc.encode(
        img, jcfg.CodecConfig(**config))


def test_encode_many_without_runtime_matches_jax(no_runtime):
    imgs = [synthetic_image(7, 96, 128), synthetic_image(12, 96, 128)]
    got = TSTREAM.encode_many(imgs, tcfg.CodecConfig(), device="cpu")
    assert got == JSTREAM.encode_many(imgs, jcfg.CodecConfig())
    assert rtt.encode(imgs[1], tcfg.CodecConfig(), device="cpu") == got[1]


@pytest.mark.parametrize("runtime", [True, False])
@pytest.mark.parametrize("seed", [7, 12])
def test_encode_debug_matches_jax(monkeypatch, seed, runtime):
    """All seven outputs; with `fast_edges` off the masks are the device
    graph's whether the runtime loads or not."""
    monkeypatch.setattr(native, "_off", not runtime)
    if not runtime:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    img = synthetic_image(seed, 96, 128)
    got = TCODEC.encode_debug(img, tcfg.CodecConfig(), device="cpu")
    want = JCODEC.encode_debug(img, jcfg.CodecConfig())
    assert set(got) == set(want) == {"roi_mask", "nonroi_mask", "seg_map", "tier1", "tier2",
                                     "tier3", "data"}
    for key in want:
        if key == "data":
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key])
    assert rtt.decode(got["data"]).shape == img.shape
