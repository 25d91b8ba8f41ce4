"""Kernel 1 (`csrc/slic_assign.cu`): the share of its roofline in the traced
slice, in %: the sum over the slice's launches of each launch's bound
(`roofline.py`, from the shapes the program's counter recorded) over the
summed device time of the `slic_assign` kernels in the trace."""

from portbench import roofline as RL


def read(ctx, suffix):
    sl = ctx.trace
    if sl is None:
        return None
    kernel_s = sum(hi - lo for lo, hi, name in sl.device if "slic_assign" in name)
    shapes = sl.counters.get("slic_assign_shapes", {})
    if kernel_s <= 0 or not shapes:
        return None
    bound = sum(n * RL.bound_s(*RL.slic_assign_ops_bytes(*key)) for key, n in shapes.items())
    return 100.0 * bound / kernel_s
