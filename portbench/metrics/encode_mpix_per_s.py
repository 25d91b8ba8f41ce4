"""Megapixels encoded per second: every image of every request started in
the window, over the time from the window's start to the end of the last of
those requests (the request in flight at the close is counted whole)."""


def read(ctx, suffix):
    span = ctx.window_end - ctx.window_start
    if not ctx.images or span <= 0:
        return None
    return ctx.pixels / 1e6 / span
