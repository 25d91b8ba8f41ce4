"""Entry: the window's wall time per image outside every top-level stage,
in ms (glue of `encode_many` or `encode` that no stage timer covers)."""

TOP = {"batch": ("s.thresholds", "s.roi_masks", "s.extract", "s.segment", "t1.pairs_dev",
                 "s.tier1", "s.tier23", "s.container"),
       "single": ("roi", "segment", "tier1", "tier23", "container")}


def read(ctx, suffix):
    if suffix not in TOP or not ctx.images:
        return None
    staged = sum(ctx.stages.get(n, {}).get("seconds", 0.0) for n in TOP[suffix])
    return 1e3 * ((ctx.window_end - ctx.window_start) - staged) / ctx.images
