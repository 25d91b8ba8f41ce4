"""K-means of tiers 1-3: the initial centres, in ms per image of the window:
every `kmeans.seed` span of `ops/cluster.py kmeans_rows` (the k-means++
draws with the noise tables drawn inside them on a cache miss, or the
uniform start), whatever stage called it (stage timers, `utils/timing.py
stage_report`).  Host time: the draws' device work that the host outruns is
waited for in `kmeans.lloyd`.  None where the program has no k-means spans."""

from portbench.harness import stage_ms_per_image


def read(ctx, suffix):
    if suffix not in ("batch", "single") or "kmeans.lloyd" not in ctx.stages:
        return None
    return stage_ms_per_image(ctx, ("kmeans.seed",))
