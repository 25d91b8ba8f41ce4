"""Device: the share of the traced slice's host time in which no kernel,
copy or set ran on the card, in %."""

from portbench import trace as TR


def read(ctx, suffix):
    sl = ctx.trace
    if sl is None or not sl.device or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - TR.busy_seconds(sl.device) / sl.window_s)
