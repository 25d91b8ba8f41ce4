"""K-means of tiers 1-3: the k-means++ noise tables drawn on the host, in ms
per image of the window: every `kmeans.noise` span, one for each miss of the
`ops/cluster.py _gumbel_table` cache (stage timers, `utils/timing.py
stage_report`); 0 where every draw hit the cache.  None where the program
has no k-means spans."""

from portbench.harness import stage_ms_per_image


def read(ctx, suffix):
    if suffix not in ("batch", "single") or "kmeans.lloyd" not in ctx.stages:
        return None
    return stage_ms_per_image(ctx, ("kmeans.noise",))
