"""PyTorch port, multi-device: the mesh, row sharding, the mesh through
encode_many / encode_stream, the banded stencil frontend, the dry run and
the scaling accounting.  The sharded encodes are byte for byte the
one-device ones and the JAX package's mesh encode (its tests run on 8
virtual CPU devices; the port's CPU meshes repeat the CPU device)."""

import numpy as np
import pytest
import torch

from roibasedimagecompression_tpu import config as jcfg
from roibasedimagecompression_tpu.parallel import mesh as JM
from roibasedimagecompression_tpu.parallel import stream as JSTREAM
from roibasedimagecompression_torch import config as tcfg
from roibasedimagecompression_torch import entry as TENTRY
from roibasedimagecompression_torch.models import pipeline_jit as TPJ
from roibasedimagecompression_torch.parallel import mesh as TM
from roibasedimagecompression_torch.parallel import scaling as SC
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.parallel import stream as TSTREAM
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


def _crops():
    """Two 96 x 96 crops of one image, as the JAX package's mesh test takes."""
    img = synthetic_image(21, 128, 128)
    return [img[:96, :96], img[16:112, 16:112]]


def test_encode_many_mesh_matches_unsharded_and_jax():
    imgs = _crops()
    mesh = TM.make_mesh(2, devices=["cpu"] * 2)
    sharded = TSTREAM.encode_many(imgs, tcfg.CodecConfig(), mesh=mesh)
    assert sharded == TSTREAM.encode_many(imgs, tcfg.CodecConfig(), device="cpu")
    assert sharded == JSTREAM.encode_many(imgs, jcfg.CodecConfig(), mesh=JM.make_mesh(2))


def test_encode_stream_mesh_matches_sequential_and_jax():
    imgs = _crops()
    batches = [imgs, imgs[::-1]]
    mesh = TM.make_mesh(2, devices=["cpu"] * 2)
    got = TSTREAM.encode_stream(batches, tcfg.CodecConfig(), workers=2, mesh=mesh)
    assert got == [TSTREAM.encode_many(b, tcfg.CodecConfig(), device="cpu") for b in batches]
    assert got == JSTREAM.encode_stream(batches, jcfg.CodecConfig(), workers=2, mesh=JM.make_mesh(2))


def test_sharded_stencil_frontend_equals_unsharded():
    imgs = np.stack([synthetic_image(s, 64, 72) for s in (5, 6)])
    for n, space in ((2, 2), (4, 2)):
        mesh = TM.make_mesh(n, space=space, devices=["cpu"] * n)
        mag, dens = TM.sharded_stencil_frontend(mesh, imgs)
        ref_mag, ref_dens = TM.stencil_frontend(imgs, device="cpu")
        assert torch.equal(mag, ref_mag) and torch.equal(dens, ref_dens)
        assert bool((dens > 0).any())


def test_sharded_batch_analysis_equals_batched():
    imgs = np.stack([synthetic_image(s, 64, 64) for s in (7, 8)])
    mesh = TM.make_mesh(2, devices=["cpu"] * 2)
    out = TM.sharded_batch_analysis(mesh, imgs, n_centers_side=4, palette_cap=512)
    ref = TPJ.batched_analysis_step(imgs, n_centers_side=4, palette_cap=512, device="cpu")
    for k in TPJ.OUTPUTS:
        assert torch.equal(out[k], ref[k]), k
    assert float(out["edge_fraction"]) == pytest.approx(float(ref["edges"].float().mean()))


def test_dryrun_multichip_cpu_mesh():
    summary = TENTRY.dryrun_multichip(4, devices=["cpu"] * 4)
    assert summary["mesh"] == {"data": 2, "space": 2}
    assert len(summary["dp_encode_bytes"]) == 4
    assert summary["per_device_work"]["ratio"] > 1.0


def test_make_mesh_raises_without_its_devices():
    with pytest.raises(ValueError):
        TM.make_mesh(3, space=2, devices=["cpu"] * 4)
    with pytest.raises(RuntimeError):
        TM.make_mesh(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TM.make_mesh(2, devices=["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError):
            TM.make_mesh(1)
    mesh = TM.make_mesh(6, space=2, devices=["cpu"] * 6)
    assert mesh.shape == {"data": 3, "space": 2} and len(mesh.data_devices) == 3


def test_shard_rows_and_call():
    mesh = TM.make_mesh(3, devices=["cpu"] * 3)
    assert SHARD.pad_rows(7, mesh) == 9 and SHARD.pad_rows(7, None) == 7
    x = SHARD.pad_to(torch.arange(14).reshape(7, 2), 9)
    assert torch.equal(x[7:], torch.tensor([[12, 13], [12, 13]]))
    sharded = SHARD.shard_rows(x, mesh)
    assert [tuple(c.shape) for c in sharded.chunks] == [(3, 2)] * 3
    with pytest.raises(ValueError):
        SHARD.shard_rows(x[:8], mesh)
    out, count = SHARD.call(lambda a, b: (a * b, len(a)), (sharded, torch.tensor(2)), {})
    assert torch.equal(out, x * 2) and count == 3
    got = SHARD.collect_all([torch.ones(3), np.zeros(2)])
    assert [g.tolist() for g in got] == [[1.0, 1.0, 1.0], [0.0, 0.0]]


def test_scaling_projection_accounting():
    """Host stages stay serial in the single-host projection; host-per-chip
    divides everything (the JAX package's identities, on the port's stage
    names)."""
    stages = {
        "s.thresholds": 0.2, "s.roi_masks": 0.6, "s.extract": 0.2,
        "s.segment": 1.0, "s.tier1": 2.4, "s.tier23": 0.5,
        "s.container": 0.6, "t1.pairs": 0.3, "t1.means": 0.1, "epscc.kmeans": 0.4,
    }
    host, device = SC.split_profile(stages)
    assert host == pytest.approx(0.2 + 0.6 + 0.2 + 0.6 + 0.3 + 0.1 + 0.4)
    assert device == pytest.approx(1.0 + 2.4 + 0.5 - 0.3 - 0.1 - 0.4)
    proj = SC.projected_throughput(stages, 3.0, 8)
    assert proj["single_host_mpps"] == pytest.approx(3.0 / (host + device / 8), abs=1e-3)
    assert proj["host_per_chip_mpps"] == pytest.approx(3.0 / ((host + device) / 8), abs=1e-3)
    assert proj["single_host_mpps"] / (3.0 / (host + device)) < 8 / 2


def test_shard_work_ratio_scales():
    """The banded frontend runs about 1/N of the work on each of N devices
    (halo rows cost the rest): >= 5x at 8 devices with space = 2."""
    mesh = TM.make_mesh(8, space=2, devices=["cpu"] * 8)
    work = SC.shard_work_ratio(mesh, shape=(8, 64, 64, 3))
    assert work["flops_1dev"] > 0 and work["flops_per_dev"] > 0
    assert work["ratio"] >= 5.0, work
