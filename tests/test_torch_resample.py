"""PyTorch port, SLIC's working-resolution resize (`ops/cuda/resample.py`,
`csrc/resample.cu`): the plain version against the host's numpy resample
(`models/segment.py _resize_uint8`) and PIL, the coefficient cache, the
wrapper's checks, the route `region_segments_many` takes and counts
(`seg.resize.card` on a CUDA device, `seg.resize.host` on the CPU) and, on a
CUDA card, the kernel against the plain version bit for bit and
`region_segments_many` on the card against its CPU labels.

Imports no JAX, so the card's machine runs it as it is:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_resample.py`.
"""

import collections

import numpy as np
import pytest
import torch

from roibasedimagecompression_torch.models import segment as SEG
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.ops.cuda import resample as RS
from roibasedimagecompression_torch.utils import timing

# (h, w, nh, nw): the benchmark's two resizes (Kodak's 768x512 and CLIC's
# 2048x1365 frames), a portrait crop, odd sizes, scales near 1 and near 0.2,
# a 1-pixel output and single-pixel axes (an axis that keeps its size gets
# no pass).
SHAPES = [
    (512, 768, 358, 537),
    (1365, 2048, 273, 409),
    (700, 300, 490, 210),
    (37, 601, 25, 420),
    (101, 203, 90, 182),
    (251, 127, 50, 25),
    (20, 20, 1, 1),
    (1, 600, 1, 540),
    (600, 1, 540, 1),
]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _image(rng, h, w, content):
    if content == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 2] = (img[: h // 2] // 32) * 32  # a coarser half
    return img


def _count(name: str) -> int:
    return timing.counters().get(name, 0)


@pytest.mark.parametrize("content", ["noisy", "flat"])
@pytest.mark.parametrize("h,w,nh,nw", SHAPES)
def test_plain_matches_host_and_pil(h, w, nh, nw, content):
    """The plain int32 version gives the host resample's bytes, and PIL's
    where PIL is installed."""
    img = _image(np.random.default_rng(h * w + nh), h, w, content)
    got = RS.resize_plain(torch.from_numpy(img), (nh, nw)).numpy()
    np.testing.assert_array_equal(got, SEG._resize_uint8(img, (nh, nw)))
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR)))


@pytest.mark.parametrize("in_size,out_size", [(768, 537), (512, 358), (2048, 409), (1365, 273),
                                              (600, 540), (20, 1), (7, 7)])
def test_coeff_table_matches_resample_coeffs(in_size, out_size):
    """The cached table is [start, count, weights] of `_resample_coeffs`, made
    once a size pair; the counts cover the input, the weights sum to about
    2^22."""
    bounds, kint = SEG._resample_coeffs(in_size, out_size)
    table = RS.coeff_table(in_size, out_size)
    assert table.dtype == np.int32 and not table.flags.writeable
    np.testing.assert_array_equal(table[:, :2], bounds)
    np.testing.assert_array_equal(table[:, 2:], kint)
    assert RS.coeff_table(in_size, out_size) is table
    assert bounds[0, 0] == 0 and (bounds.sum(1) <= in_size).all() and bounds[-1].sum() == in_size
    assert (np.abs(kint.sum(1) - (1 << 22)) <= kint.shape[1]).all()
    assert (kint[np.arange(kint.shape[1])[None, :] >= bounds[:, 1:]] == 0).all()


@pytest.mark.parametrize("case", ["dtype", "channels", "dims", "transposed", "strided pixels",
                                  "empty output", "lengths", "devices"])
def test_wrapper_checks(case):
    """`resize_many` refuses what the kernel does not take."""
    img = torch.zeros((20, 30, 3), dtype=torch.uint8)
    images, shapes = [img], [(10, 15)]
    if case == "dtype":
        images = [img.to(torch.int32)]
    elif case == "channels":
        images = [torch.zeros((20, 30, 4), dtype=torch.uint8)]
    elif case == "dims":
        images = [torch.zeros((20, 30), dtype=torch.uint8)]
    elif case == "transposed":
        images = [img.transpose(0, 1)]
    elif case == "strided pixels":
        images = [torch.zeros((20, 60, 3), dtype=torch.uint8)[:, ::2]]
    elif case == "empty output":
        shapes = [(0, 15)]
    elif case == "lengths":
        shapes = [(10, 15), (5, 5)]
    elif case == "devices":
        images = [img, torch.zeros((20, 30, 3), dtype=torch.uint8, device="meta")]
        shapes = [(10, 15), (10, 15)]
    with pytest.raises(ValueError):
        RS.resize_many(images, shapes)


def test_resize_many_on_the_cpu_takes_slices():
    """On the CPU every row takes the plain version, a slice of a larger
    image (rows with a pitch) included; no launch is recorded."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.integers(0, 256, (2, 90, 700, 3), dtype=np.uint8))
    rows = [big[0, 5:80, 10:650], big[1], big[1, :1, 3:603]]
    shapes = [(67, 576), (81, 630), (1, 540)]
    before = _build.launched["resample"].total()
    got = RS.resize_many(rows, shapes)
    assert _build.launched["resample"].total() == before
    for row, shape, out in zip(rows, shapes, got):
        assert out.shape == (*shape, 3) and out.is_contiguous()
        np.testing.assert_array_equal(out.numpy(), SEG._resize_uint8(row.numpy(), shape))


def _segment_inputs(device):
    """Two 64x560 images, each with a full-frame non-ROI region around a hole
    (scaled to 57x504) and an ROI box in the hole (unscaled), and a portrait
    540x64 crop that no device batch holds (scaled to 486x57): (crops, masks,
    n_segments, sources, dbatch), region j's raster id j + 1."""
    rng = np.random.default_rng(11)
    h, w = 64, 560
    yy, xx = np.mgrid[:h, :w]
    images = np.stack([
        np.clip(np.stack([xx * 255 // w, yy * 255 // h, (xx + yy + 40 * k) % 256], -1)
                + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        for k in range(2)])
    box = np.zeros((h, w), bool)
    box[10:40, 100:140] = True
    reg_nonroi = np.zeros((2, h, w), np.int32)
    reg_roi = np.zeros((2, h, w), np.int32)
    crops, masks, sources = [], [], []
    for k in range(2):
        reg_nonroi[k][~box] = 2 * k + 1
        reg_roi[k][box] = 2 * k + 2
        crops += [images[k], images[k][10:40, 100:140]]
        masks += [~box, np.ones((30, 40), bool)]
        sources += [(k, 0, 0, h, w, 2 * k + 1, 0), (k, 10, 100, 30, 40, 2 * k + 2, 1)]
    crops.append(np.ascontiguousarray(np.transpose(images[1][:, 10:550], (1, 0, 2))))
    masks.append(np.ones((540, 64), bool))
    sources.append(None)
    dbatch = SEG.DeviceBatch(images, reg_nonroi, reg_roi, device)
    return crops, masks, [12, 3, 14, 4, 9], sources, dbatch


@pytest.mark.parametrize("with_batch", [True, False])
def test_resize_route_and_counters(monkeypatch, with_batch):
    """On the CPU the scaled rows take the host resample (`seg.resize.host`,
    one a row); on a CUDA device (here the CPU, asked as one) they take
    `resize_many` once (`seg.resize.card`), rows of the device batch sliced
    from it, and SLIC gives the same labels."""
    crops, masks, n_seg, sources, dbatch = _segment_inputs("cpu")
    kw = {"sources": sources, "dbatch": dbatch} if with_batch else {}

    def run():
        return SEG.region_segments_many(crops, masks, n_seg, "cpu", **kw)

    before = _count("seg.resize.host"), _count("seg.resize.card")
    want = run()
    assert (_count("seg.resize.host"), _count("seg.resize.card")) == (before[0] + 3, before[1])
    calls = []

    resize_many = RS.resize_many

    def resize(rows, shapes):
        in_batch = dbatch.img.untyped_storage().data_ptr() if with_batch else None
        calls.append([(tuple(r.shape), tuple(s), r.untyped_storage().data_ptr() == in_batch)
                      for r, s in zip(rows, shapes)])
        return resize_many(rows, shapes)

    monkeypatch.setattr(SEG, "_on_card", lambda dev: True)
    monkeypatch.setattr(RS, "resize_many", resize)
    got = run()
    assert (_count("seg.resize.host"), _count("seg.resize.card")) == (before[0] + 3, before[1] + 3)
    assert calls == [[((64, 560, 3), (57, 504), with_batch), ((64, 560, 3), (57, 504), with_batch),
                      ((540, 64, 3), (486, 57), False)]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert max(int(lab.max()) for lab in want) > 1


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    """One launch resizes a batch of mixed rows: slices of a device batch,
    uploaded crops, portrait and landscape, an axis left as it is, a 1-pixel
    output; every byte equals the plain version's."""
    rng = np.random.default_rng(7)
    batch = torch.from_numpy(rng.integers(0, 256, (3, 512, 768, 3), dtype=np.uint8)).to(cuda)
    rows, shapes = [], []
    for k in range(3):
        rows.append(batch[k])
        shapes.append((358, 537))
    rows.append(batch[1, 17:450, 200:761])
    shapes.append((303, 392))
    rows.append(batch[2, 3:4, 0:700])
    shapes.append((1, 630))
    rows.append(batch[0, :, 5:6])
    shapes.append((358, 1))
    for h, w, nh, nw in SHAPES[1:]:
        rows.append(torch.from_numpy(_image(rng, h, w, "noisy")).to(cuda))
        shapes.append((nh, nw))
    key = tuple(sorted(collections.Counter((r.shape[0], r.shape[1], *s) for r, s in zip(rows, shapes)).items()))
    before = _build.launched["resample"].total(), _build.launched["resample"][key]
    got = RS.resize_many(rows, shapes)
    torch.cuda.synchronize()
    assert (_build.launched["resample"].total(), _build.launched["resample"][key]) == (before[0] + 1, before[1] + 1)
    for row, shape, out in zip(rows, shapes, got):
        want = RS.resize_plain(row.cpu(), shape)
        assert torch.equal(out.cpu(), want), (tuple(row.shape), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("with_batch", [True, False])
def test_region_segments_on_the_card(cuda, with_batch):
    """`region_segments_many` on the card takes the kernel for every scaled
    row, once a call, and gives the CPU's labels."""
    crops, masks, n_seg, sources, dbatch = _segment_inputs("cpu")
    want = SEG.region_segments_many(crops, masks, n_seg, "cpu", sources=sources, dbatch=dbatch)
    crops, masks, n_seg, sources, dbatch = _segment_inputs(cuda)
    kw = {"sources": sources, "dbatch": dbatch} if with_batch else {}
    before = _build.launched["resample"].total(), _count("seg.resize.card")
    got = SEG.region_segments_many(crops, masks, n_seg, cuda, **kw)
    assert (_build.launched["resample"].total(), _count("seg.resize.card")) == (before[0] + 1, before[1] + 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
