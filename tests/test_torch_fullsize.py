"""PyTorch port against the JAX package's answers on Kodak-shaped images.

`tests/data/jax_parity_768x512.json` holds the JAX package's payload digest
(sha256 of the unpacked palette's bytes, the index matrix's bytes and its
shape), container length at level 0, PSNR and SSIM for every path of
`scripts/port_parity_fullsize.py` on `synthetic_image(seed, 512, 768)`, and
for three crops of those images, which tier 1 can afford on one torch
thread.  `chip_smoke.py` holds the card's encodes against the same file.

- `test_digests_are_the_jax_packages` encodes each of the three crops with
  the JAX package and finds the file's digest: the file is the JAX
  package's on this host (a host whose XLA thread count gives other bytes,
  ROADMAP §C10, fails here first).
- `test_port_matches_jax_digests_fullsize` encodes with the port on the CPU
  and finds the file's digest, which the test above holds to the JAX
  package's: the loop with its ROI frontend on a crop of seed 102 that holds
  ROI pixels, and the weighted k-means split on a crop of seed 101 whose
  k-means rows pass 65,793 pixels (ROADMAP §C11).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import roibasedimagecompression_torch as rtt
from roibasedimagecompression_torch.io import container as TC
from roibasedimagecompression_torch.models import roi as TROI
from roibasedimagecompression_torch.models import roi_fused as TROIF
from roibasedimagecompression_torch.ops import cluster as TCL
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

DATA = pathlib.Path(__file__).resolve().parent / "data" / "jax_parity_768x512.json"
CLIC_DATA = DATA.with_name("jax_parity_1365x2048.json")
C11_LINE = 2**24 // 255  # 65,793 pixels


@pytest.fixture()
def one_thread():
    """The test's torch work on one thread: the suite runs several worker
    processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(row: str, seed: int, data: pathlib.Path = DATA) -> dict:
    with open(data) as f:
        doc = json.load(f)
    return next(e for e in doc["entries"] if e["row"] == row and e["seed"] == seed)


def _image(entry: dict, data: pathlib.Path = DATA) -> np.ndarray:
    h, w = json.loads(data.read_text())["shape"]
    img = synthetic_image(entry["seed"], h, w)
    if entry["crop"] is not None:
        y0, x0, ch, cw = entry["crop"]
        img = np.ascontiguousarray(img[y0 : y0 + ch, x0 : x0 + cw])
    return img


def _check(entry: dict, data: bytes) -> None:
    assert TC.payload_digest(data) == entry["digest"]
    p = TC.unpack(data)
    assert len(TC.pack(p.palette, p.indices, level=0)) == entry["container_len_level0"]


CROPS = [("a-crop", 102), ("e1-crop", 102), ("g-crop", 101)]


@pytest.mark.parametrize("row,seed", CROPS)
def test_digests_are_the_jax_packages(one_thread, row, seed):
    """The JAX package's CPU encode of each crop gives the file's digest:
    row a (`encode` at CodecConfig()) on the crop of seed 102, which holds
    ROI pixels, and the two crops that the port is held to below."""
    import roibasedimagecompression_tpu as rtc

    entry = _entry(row, seed)
    img = _image(entry)
    assert entry["crop"] is not None
    if row == "a-crop":
        assert TROIF.roi_masks(img, rtt.CodecConfig(), "cpu")[0].any()
    _check(entry, rtc.encode(img, rtc.CodecConfig(**entry["config"])))


@pytest.mark.parametrize("row,seed", CROPS[1:])
def test_port_matches_jax_digests_fullsize(one_thread, monkeypatch, row, seed):
    """The port's CPU encode gives the JAX package's digest: the loop
    (`batched=False`) through its ROI frontend, and the weighted k-means
    split with sums past 2^24 at the 1024-point chunk."""
    entry = _entry(row, seed)
    img = _image(entry)
    config = rtt.CodecConfig(**entry["config"])
    totals = []
    inner = TCL._weighted_sums

    def recorded(labels, w, points, valid, k_max):
        totals.append((float(w.double().sum(dim=1).max()), int(points.shape[1])))
        return inner(labels, w, points, valid, k_max)

    monkeypatch.setattr(TCL, "_weighted_sums", recorded)
    _check(entry, rtt.encode(img, config, device="cpu"))
    if row.startswith("e1"):
        assert TROI.roi_masks(img, config, "cpu")[0].any()
    else:
        assert max(t for t, m in totals if m == 1024) > C11_LINE


def test_port_matches_jax_digest_on_a_clic_crop(one_thread, monkeypatch):
    """A 720x1040 crop of a CLIC-sized photograph, `synthetic_image(103,
    1365, 2048)`: the port's CPU `encode_many` gives the JAX package's
    digest (`tests/data/jax_parity_1365x2048.json`, written by
    `scripts/port_parity_fullsize.py --shape 1365x2048 --rows b-crop`), and
    its tier 1 runs a k-means at k_max 512 from the uniform start."""
    from roibasedimagecompression_torch.parallel import stream as TSTREAM
    from roibasedimagecompression_torch.utils import timing

    entry = _entry("b-crop", 103, CLIC_DATA)
    img = _image(entry, CLIC_DATA)
    k_maxes = []
    inner = TCL.kmeans_rows

    def recorded(points, valid, k, *, k_max, **kw):
        k_maxes.append(k_max)
        return inner(points, valid, k, k_max=k_max, **kw)

    monkeypatch.setattr(TCL, "kmeans_rows", recorded)
    timing.reset_stages()
    _check(entry, TSTREAM.encode_many([img], rtt.CodecConfig(**entry["config"]), "cpu")[0])
    assert max(k_maxes) > 256
    assert timing.counters()["kmeans_init.uniform"] >= 1
    timing.reset_stages()
