"""Segment: SLIC's working-resolution resize, in ms per image of the window:
the `seg.resize` stage of `models/segment.py region_segments_many` (stage
timers, `utils/timing.py stage_report`), around the resize of every region
over the working resolution.  Host time: on a CUDA device the time to queue
the resize kernel's one launch a call (and to make a size pair's
coefficient tables, the first time), on the CPU the host resample itself.
None where the program has no such stage."""

from portbench.harness import stage_ms_per_image


def read(ctx, suffix):
    if suffix not in ("batch", "single") or "seg.resize" not in ctx.stages:
        return None
    return stage_ms_per_image(ctx, ("seg.resize",))
