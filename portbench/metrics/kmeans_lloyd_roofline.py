"""K-means of tiers 1-3: the share of the Lloyd loop's time that the
roofline bound of its counted assignment work would take, in %.

The work is the program's counter `kmeans_assign_pairs` (`ops/cluster.py
kmeans_rows`: every assignment pass, the sum over rows of valid points x
k, without the padding); the time is the `kmeans.lloyd` stage's seconds.
Both are read live when the readers run, after the traced slice, so both
cover the window and the slice together (`utils/timing.py` clears them at
the window's start).

Operations a pair (`lloyd_ops_bytes`), a multiply-add counted as one, as
`roofline.py` counts: the 3-deep dot product of point and centre as three
multiply-adds, |p|^2 + |c|^2 as an add, minus 2 p.c as a multiply and a
subtract, the clamp at 0, and the compare and the select of the argmin:
9.  The squared norms are per point or per centre and left out.  Bytes a
pass: the valid points read (3 float32 each, 12 B), the k centres read
(12 B each) and a label written per point (int32, 4 B).  The counter holds
pairs, not the points and centres of each pass, so the bytes enter at 0:
at 9 operations a pair against (16 / k + 12 / n) bytes a pair, the
operations bound every pass with k >= 36 (every k-means of tier 1, where
n >= 10,000 colours and k >= 100), and a pass with fewer centres is
understated, which can only lower the share.

The bound is `roofline.bound_s` (67 TFLOP/s float32, 3.35 TB/s).  The
denominator is host time that holds each pass's wait for the card and the
centre updates, so the share is understated too: it is the yardstick of
the assignment, whatever kernel implements it.  None where the program has
no such counter or no `kmeans.lloyd` stage."""

from portbench import roofline as RL

OPS_PER_PAIR = 9


def lloyd_ops_bytes(pairs: float) -> tuple:
    """(operations, bytes) of `pairs` counted (point, centre) pairs."""
    return OPS_PER_PAIR * pairs, 0.0


def share_pct(pairs: float, lloyd_s: float) -> float | None:
    """100 x the bound of `pairs` over `lloyd_s` seconds of Lloyd."""
    if lloyd_s <= 0:
        return None
    return 100.0 * RL.bound_s(*lloyd_ops_bytes(pairs)) / lloyd_s


def read(ctx, suffix):
    from roibasedimagecompression_torch.utils import timing

    if suffix not in ("batch", "single") or not hasattr(timing, "counters"):
        return None
    pairs = timing.counters().get("kmeans_assign_pairs")
    lloyd = timing.stage_report().get("kmeans.lloyd")
    if pairs is None or lloyd is None:
        return None
    return share_pct(pairs, lloyd["seconds"])
