"""K-means of tiers 1-3: the assignment work, in billions of (point,
centre) pairs per image, from the program's counter `kmeans_assign_pairs`
(`ops/cluster.py kmeans_rows`: for every assignment pass, the Lloyd passes
and the last, the sum over rows of valid points x that row's k, without the
padding).  Read as `kmeans_iters_per_image.py` reads its counter: the live
registry when the readers run, after the traced slice, so it counts the
window's images and the slice's, over both.  None where the program has no
such counter."""


def read(ctx, suffix):
    from roibasedimagecompression_torch.utils import timing

    if suffix not in ("batch", "single") or not hasattr(timing, "counters"):
        return None
    pairs = timing.counters().get("kmeans_assign_pairs")
    images = ctx.images + (ctx.trace.images if ctx.trace is not None else 0)
    if pairs is None or not images:
        return None
    return pairs / 1e9 / images
