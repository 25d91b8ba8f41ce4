"""PyTorch port, the entry surface: the fused device core (`analysis_step`,
`batched_analysis_step`) and the entry hooks (`entry`), held against the
jitted JAX function and `__graft_entry__.entry` on the same inputs.  All
nine outputs are equal (dtype, shape and every value)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as JENTRY
from roibasedimagecompression_tpu.models import pipeline_jit as JPJ
from roibasedimagecompression_torch import entry as TENTRY
from roibasedimagecompression_torch.models import pipeline_jit as TPJ
from roibasedimagecompression_torch.utils.synthetic import synthetic_image


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test's torch work on one thread and restores the count after:
    the suite runs several worker processes on the host's cores, and a torch
    thread pool per worker only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_outputs_equal(got: dict, want: dict):
    assert set(TPJ.OUTPUTS) <= set(got)
    for k in TPJ.OUTPUTS:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("seed,h,w,side,cap", [
    (1, 64, 64, 4, 512),
    (2, 96, 128, 6, 2048),
    (None, 64, 64, 4, 512),  # uniform noise: more colours than palette slots
])
def test_analysis_step_matches_jax(seed, h, w, side, cap):
    if seed is None:
        img = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        img = synthetic_image(seed, h, w)
    want = JPJ.analysis_step(jnp.asarray(img), n_centers_side=side, palette_cap=cap, quality=20.0)
    got = TPJ.analysis_step(img, n_centers_side=side, palette_cap=cap, quality=20.0, device="cpu")
    _assert_outputs_equal(got, want)


def test_batched_analysis_step_equals_singles():
    imgs = np.stack([synthetic_image(3, 64, 64), synthetic_image(4, 64, 64)])
    batch = TPJ.batched_analysis_step(imgs, n_centers_side=4, palette_cap=512, device="cpu")
    for k in range(2):
        one = TPJ.analysis_step(imgs[k], n_centers_side=4, palette_cap=512, device="cpu")
        for name in TPJ.OUTPUTS:
            assert torch.equal(batch[name][k], one[name]), name


def test_entry_matches_graft_entry():
    """The port's entry() is `__graft_entry__.entry`'s: the same 256 x 256 image and
    the same nine outputs."""
    fn, args = TENTRY.entry()
    jfn, jargs = JENTRY.entry()
    np.testing.assert_array_equal(args[0], np.asarray(jargs[0]))
    _assert_outputs_equal(fn(*args, device="cpu"), jfn(*jargs))


def test_entry_points_default_to_cuda():
    """No CUDA entry point carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fn, args = TENTRY.entry()
    with pytest.raises(RuntimeError):
        fn(*args)
    with pytest.raises(RuntimeError):
        TENTRY.dryrun_multichip(2)
