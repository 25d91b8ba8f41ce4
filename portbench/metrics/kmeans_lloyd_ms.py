"""K-means of tiers 1-3: the Lloyd loop, in ms per image of the window:
every `kmeans.lloyd` span of `ops/cluster.py kmeans_rows` (the assignment
passes, the centre updates and the last assignment), whatever stage called
it (stage timers, `utils/timing.py stage_report`).  Host time: each pass
ends in a wait for the card, so its device work is inside.  None where the
program has no k-means spans."""

from portbench.harness import stage_ms_per_image


def read(ctx, suffix):
    if suffix not in ("batch", "single") or "kmeans.lloyd" not in ctx.stages:
        return None
    return stage_ms_per_image(ctx, ("kmeans.lloyd",))
