"""K-means of tiers 1-3: Lloyd iterations per image, from the program's
counter `kmeans_iters` (`utils/timing.py counters`, cleared with the stages
at the window's start).  Unlike the other readers it reads global program
state when it is called, not a value fixed in `ctx` when the window
closed, so its number rests on where `run.py` calls the readers: after the
traced slice and before the reference's check (which runs no program
code).  It therefore counts the iterations of the window's images and of
the slice's, over both; program work run between the slice and the
readers would be counted too, and nothing would report it.  None where the
program has no such counter."""


def read(ctx, suffix):
    from roibasedimagecompression_torch.utils import timing

    if suffix not in ("batch", "single") or not hasattr(timing, "counters"):
        return None
    iters = timing.counters().get("kmeans_iters")
    images = ctx.images + (ctx.trace.images if ctx.trace is not None else 0)
    if iters is None or not images:
        return None
    return iters / images
