"""Batched multi-image encoding: the throughput path.

The counterpart of the JAX package's `parallel/stream.py`.  Three levers:

  1. All regions of a same-shape batch pool into the same split-score and
     SLIC buckets (codec.build_segment_maps_many).
  2. Tier-1 palette clustering runs once for the whole batch: the per-image
     segment maps stack into one tall map with globally unique segment ids
     (one eps-CC run per segment keeps this exact), and its pair table is
     built on the device from the pixels the segment stage left there
     (ops/pairs.py).
  3. Host-side container packing (DEFLATE releases the interpreter lock) runs
     in a thread pool, the frontend's per-image native work (Canny
     thresholds, ROI masks) in another, and `encode_stream` runs whole
     batches on worker threads, each sending its device work to a CUDA
     stream of its own.

With `mesh` (`parallel/mesh.py make_mesh`), the data-parallel deployment
path: every bucketed device stage (split score, SLIC, the eps-CC rows, the
k-means splits; and without the runtime the ROI masks, image by image)
splits its rows over the mesh's data devices, each shard on its owner, and
gathers on the mesh's first device, which then stands in for `device`.  The
bytes equal the one-device encode's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading

import numpy as np
import torch

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch import native
from roibasedimagecompression_torch.io import container
from roibasedimagecompression_torch.models import codec as CODEC
from roibasedimagecompression_torch.models import quantize_batched as QB
from roibasedimagecompression_torch.models import refine as REFINE
from roibasedimagecompression_torch.models import roi_fused as RF
from roibasedimagecompression_torch.ops import canny as CANNY
from roibasedimagecompression_torch.ops import pairs as PAIRS
from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import device as DEV
from roibasedimagecompression_torch.utils import timing
from roibasedimagecompression_torch.utils.timing import stage_timer

# One process-wide container-packing pool serves every encode_many: per-call
# pools cost thread churn and, under encode_stream, oversubscribe the host.
_IO_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_IO_LOCK = threading.Lock()


def _io_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _IO_POOL
    with _IO_LOCK:
        if _IO_POOL is None:
            _IO_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="rhccq-io"
            )
        return _IO_POOL


# One process-wide frontend pool runs the batch frontend's per-image native
# work (Canny thresholds, then ROI masks); encode_stream's _frontend_done gate
# lets one batch's frontend run at a time, so one pool does not oversubscribe.
_FRONTEND_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_FRONTEND_LOCK = threading.Lock()


def _frontend_pool() -> concurrent.futures.ThreadPoolExecutor | None:
    """The frontend pool, one thread a usable core up to 8; None without
    the runtime (the masks are then a device graph, the thresholds one
    batched device analysis) or on one usable core, where a pool only adds
    switches."""
    cores = len(os.sched_getaffinity(0))
    if not native.available() or cores <= 1:
        return None
    global _FRONTEND_POOL
    with _FRONTEND_LOCK:
        if _FRONTEND_POOL is None:
            _FRONTEND_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, cores), thread_name_prefix="rhccq-frontend"
            )
        return _FRONTEND_POOL


def _mesh_device(device, mesh) -> torch.device:
    """The device the encode runs on: a mesh's first device overrides
    `device`."""
    return mesh.first if mesh is not None else DEV.resolve(device)


def encode_many(
    images: list, config: cfg.CodecConfig | None = None, device=None, mesh=None,
    _start_gate: threading.Event | None = None,
    _frontend_done: threading.Event | None = None,
) -> list:
    """Encode a list of same-shape (h, w, 3) uint8 images -> list of bytes.

    device=None runs on CUDA (and raises without a card); pass "cpu" for the
    CPU.  With `mesh`, the bucketed device stages split their rows over the
    mesh's data devices (see the module docstring).  Each image's bytes
    equal `encode(image, config)`.

    _start_gate/_frontend_done stagger concurrent pipelines (encode_stream):
    the batch waits on _start_gate before doing any work and sets
    _frontend_done once its host-serial frontend (thresholds, ROI masks,
    extraction) is finished.
    """
    config = config or cfg.CodecConfig()
    try:
        if _start_gate is not None:
            _start_gate.wait()
        with timing.request("encode_many"):
            return _encode_many_inner(images, config, _mesh_device(device, mesh), _frontend_done, mesh)
    finally:
        # Always unblock the successor, even on failure mid-frontend.
        if _frontend_done is not None:
            _frontend_done.set()


def _segment_stack(batch: np.ndarray, config: cfg.CodecConfig, device,
                   frontend_done: threading.Event | None = None, mesh=None):
    """Frontend and segment stage of a (b, h, w, 3) uint8 batch: thresholds,
    ROI masks, region extraction, then split score and SLIC with all regions
    of all images pooled into the same buckets.

    Returns (tall_seg (b * h, w) int32 with globally unique segment ids,
    seg_quality, seg_group, image_of_seg (each n_segments + 1, entry 0 the
    background), dbatch: the batch on the device, or None without regions).
    """
    b, h, w, _ = batch.shape
    min_size = cfg.min_region_size(h * w * 3)

    # 1. Thresholds and ROI masks for the whole batch.
    if config.single_region:
        roi_masks = np.ones((b, h, w), bool)
        nonroi_masks = np.zeros((b, h, w), bool)
    else:
        pool = _frontend_pool()
        with stage_timer("s.thresholds"):
            if config.fast_edges:
                lows, highs = CANNY.fast_thresholds_many(batch, device)
            else:
                lows, highs = CANNY.select_thresholds_many(batch, device, pool)
        with stage_timer("s.roi_masks"):
            # Without the runtime the masks are a device graph, and a mesh
            # runs image k on the owner of its data shard.
            owners = [device] * b
            if mesh is not None:
                per = SHARD.pad_rows(b, mesh) // SHARD.data_axis_size(mesh)
                owners = [mesh.data_devices[k // per] for k in range(b)]

            def one_mask(k):
                return RF.roi_masks_fast(batch[k], config, lows[k], highs[k], owners[k])

            # The mask chain is native host work that releases the
            # interpreter lock.  Without the runtime it is the device graph,
            # one image at a time.
            if pool is not None:
                masks = list(pool.map(timing.carry(one_mask), range(b)))
            else:
                masks = [one_mask(k) for k in range(b)]
            roi_masks = np.stack([m[0] for m in masks])
            nonroi_masks = np.stack([m[1] for m in masks])

    # 2. Batched segmentation -> one stacked tall segment map.
    with stage_timer("s.extract"):
        regions_per_image = [
            CODEC._extract_and_assign(batch[k], roi_masks[k], nonroi_masks[k], config, min_size, device)
            for k in range(b)
        ]
    if frontend_done is not None:
        # Host-serial prefix over: from here on this batch alternates device
        # waits with host stages, so the next batch's frontend may start.
        frontend_done.set()
    with stage_timer("s.segment"):
        seg_results, dbatch = CODEC.build_segment_maps_many(
            [batch[k] for k in range(b)], regions_per_image, config, device,
            return_dbatch=True, mesh=mesh,
        )
    seg_maps = []
    qualities = [np.zeros(1)]
    groups_list = [np.zeros(1, np.int32)]
    images_list = [np.zeros(1, np.int32)]
    next_id = 0
    for k, (seg_map, seg_q, seg_g) in enumerate(seg_results):
        seg_maps.append(np.where(seg_map > 0, seg_map + next_id, 0))
        qualities.append(seg_q[1:])
        groups_list.append(seg_g[1:])
        images_list.append(np.full(len(seg_q) - 1, k, np.int32))
        next_id += len(seg_q) - 1
    return (np.concatenate(seg_maps, axis=0), np.concatenate(qualities),
            np.concatenate(groups_list), np.concatenate(images_list), dbatch)


def _encode_many_inner(images: list, config: cfg.CodecConfig, device,
                       frontend_done: threading.Event | None, mesh=None) -> list:
    if not images:
        return []
    shape = images[0].shape
    for im in images:
        if im.shape != shape:
            raise ValueError("encode_many requires same-shape images")
    batch = np.stack([np.asarray(im, np.uint8) for im in images])
    b, h, w, _ = batch.shape
    tall_img = batch.reshape(b * h, w, 3)
    tall_seg, seg_quality, seg_group, image_of_seg, dbatch = _segment_stack(
        batch, config, device, frontend_done, mesh
    )

    # 3. One tier-1 pass across every segment of every image, as a cluster
    #    table.  The segment stage left the batch's pixels on the device, so
    #    the pair table is a sort there; RHCCQ_DEVICE_PAIRS=0 switches to the
    #    host radix pack and the host index paint (the same bytes).
    # The canvas tiers path paints pixels on the host, so it skips the device
    # pair table, as the JAX package does, and so does a mesh run.
    canvas = CODEC.canvas_tiers(config)
    device_pairs = None
    # Without the native runtime the table is the host's, as in the JAX
    # package (its repair runs on the runtime).
    if (dbatch is not None and not canvas and mesh is None and native.available()
            and os.environ.get("RHCCQ_DEVICE_PAIRS", "1") != "0"):
        with stage_timer("t1.pairs_dev"):
            device_pairs = PAIRS.DevicePairTable(tall_seg, images_dev=dbatch.img)
    with stage_timer("s.tier1"):
        table = QB.tier1_table(
            tall_img, tall_seg, seg_quality, device, seed=config.seed,
            weighted=config.weighted_palette, split_method=config.split_method,
            split_margin=config.split_margin, weighted_split=config.weighted_split,
            device_pairs=device_pairs, mesh=mesh,
        )

    if canvas:
        return _finish_canvas_path(table, tall_seg, seg_group, batch, config, device, mesh)

    # 4. Tiers 2/3 and the final palettes composed on the cluster table;
    #    pixels are touched once more, for the final index paint.
    if table is None:
        pal_idx = [(np.zeros((1, 3), np.uint8), np.zeros((h, w), np.uint8))] * b
    else:
        with stage_timer("s.tier23"):
            # refit_originals: the zero-rate palette refit happens inside.
            pal_idx = CODEC.tiers23_palette_indices(
                table, seg_group, image_of_seg, b, (h, w), config, device,
                refit_originals=batch, mesh=mesh,
            )

    # 5. Container packing in the shared thread pool.
    def finish(k: int) -> bytes:
        palette, indices = pal_idx[k]
        with stage_timer("container.pack"):
            return container.pack(palette, indices, level=config.container_level)

    with stage_timer("s.container"):
        return list(_io_pool().map(timing.carry(finish), range(b)))


def _finish_canvas_path(table, tall_seg, seg_group, batch, config, device, mesh=None) -> list:
    """Tiers 2/3 on canvases (fill_black_holes edits the tier-2 canvas
    before tier 3; RHCCQ_CANVAS_TIERS=1 asks for the path), then palettes,
    refit and the containers."""
    b, h, w, _ = batch.shape
    t1_tall = np.zeros((b * h, w, 3), np.uint8)
    if table is not None:
        QB.paint_table(table, t1_tall)
    t1_list = [t1_tall[k * h : (k + 1) * h] for k in range(b)]
    group_maps = [seg_group[tall_seg[k * h : (k + 1) * h]] for k in range(b)]
    with stage_timer("s.tier23"):
        _, t3_list = CODEC.tiers23_colors_many(t1_list, group_maps, config, device, mesh=mesh)

    def finish(k: int) -> bytes:
        palette, indices = CODEC.canvas_palette_indices(t3_list[k], t1_list[k], config, device)
        palette = REFINE.maybe_refit(batch[k], palette, indices, config)
        with stage_timer("container.pack"):
            return container.pack(palette, indices, level=config.container_level)

    with stage_timer("s.container"):
        return list(_io_pool().map(timing.carry(finish), range(b)))


def encode_stream(batches: list, config: cfg.CodecConfig | None = None,
                  workers: int = 2, device=None, mesh=None) -> list:
    """Encode a stream of same-shape batches on `workers` threads.

    Several encode_many pipelines run on separate threads: while one waits on
    a device result or runs native host code (both release the interpreter
    lock), another runs its own stages.  On CUDA each worker thread puts its
    batches on a stream of its own, so kernels of two batches may overlap on
    the card.  Starts are staggered: batch k begins only when batch k-1 has
    finished its host-serial frontend, so the pipelines stay phase-shifted.
    Each batch's bytes equal a sequential encode_many.  With `mesh`, each
    batch is `encode_many(..., mesh=mesh)`, and a worker owns a stream on
    every CUDA device of the mesh.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py`, 3 batches
    of 8 images of 768x512), workers=2 is slower than sequential encode_many
    calls: 21.4-26.3 s against 15.0-16.7 s, 0.64-0.75x.  A batch is tens of
    thousands of small launches made from Python, which two threads only
    hand to each other; until the k-means loops run on the card, call
    encode_many in sequence there (or pass workers=1).

    Returns a list of per-batch result lists, in input order.
    """
    config = config or cfg.CodecConfig()
    with timing.request("encode_stream"):
        return _encode_stream_inner(batches, config, workers, _mesh_device(device, mesh), mesh)


def _encode_stream_inner(batches: list, config: cfg.CodecConfig, workers: int, dev, mesh) -> list:
    if workers <= 1 or len(batches) <= 1:
        return [encode_many(b, config, dev, mesh=mesh) for b in batches]
    gates = [threading.Event() for _ in range(len(batches) + 1)]
    gates[0].set()
    local = threading.local()  # each worker thread's CUDA streams, one per device
    cuda_devs = sorted({d for d in (mesh.devices.reshape(-1) if mesh is not None else [dev])
                        if d.type == "cuda"}, key=str)

    def run(k: int) -> list:
        if not cuda_devs:
            return encode_many(
                batches[k], config, dev, mesh=mesh, _start_gate=gates[k], _frontend_done=gates[k + 1],
            )
        if not hasattr(local, "streams"):
            local.streams = [torch.cuda.Stream(d) for d in cuda_devs]
        try:
            with contextlib.ExitStack() as stack:
                for s in local.streams:
                    stack.enter_context(torch.cuda.stream(s))
                return encode_many(
                    batches[k], config, dev, mesh=mesh, _start_gate=gates[k], _frontend_done=gates[k + 1],
                )
        finally:
            for s in local.streams:
                s.synchronize()

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(timing.carry(run), range(len(batches))))
