"""Device: the host's waits on the card per image of the traced slice: the
CUDA runtime's synchronising calls among the slice's host events
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`
and the blocking `cudaMemcpy`; a `.item()`, `.cpu()` or `bool()` of a CUDA
tensor is a copy and a stream synchronise)."""

SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})


def read(ctx, suffix):
    sl = ctx.trace
    if suffix not in ("batch", "single") or sl is None or not sl.device or not sl.images:
        return None
    return sum(1 for _, _, name in sl.host if name in SYNCS) / sl.images
