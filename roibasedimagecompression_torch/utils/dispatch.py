"""Every batched device call of the codec goes through `call`: recorded for a
warm-up manifest, its operations counted, run inline and shard by shard."""

from __future__ import annotations

from roibasedimagecompression_torch.parallel import shard as SHARD
from roibasedimagecompression_torch.utils import flops, warmup


def call(fn, *args, **kwargs):
    """fn(*args, **kwargs), its value returned and its exception raised:
    recorded (`warmup.record_call`), counted (`flops.track`) and run over
    the shards of a sharded argument (`parallel/shard.py call`)."""
    warmup.record_call(fn, args, kwargs)
    return flops.track(SHARD.call, (fn, args, kwargs), {})
