"""Device: kernels, copies and sets on the card per image of the traced
slice."""


def read(ctx, suffix):
    sl = ctx.trace
    if sl is None or not sl.device or not sl.images:
        return None
    return len(sl.device) / sl.images
