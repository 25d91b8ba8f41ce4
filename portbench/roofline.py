"""The yardstick's table of peaks and the operations and bytes of the
program's kernels, computed from their launch shapes.

Peaks: NVIDIA's data sheet for one H100 SXM at its full 700 W, dense rates:
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.  A card
set below 700 W reaches less; `run.py` prints the card's power limit.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: max(operations / peak FLOP/s,
    bytes / peak bytes/s), in seconds."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def slic_assign_ops_bytes(form: str, b: int, mp: int, k: int) -> tuple:
    """(operations, bytes) of one `slic_assign` launch: the nearest of K
    5-D centres for B x MP pixels.  Operations a pixel-centre pair: the
    direct form 17 (five differences, five multiply-adds of their squares,
    the compare and the select of the argmin), the expanded form 15 (the
    5-deep dot product as five multiply-adds, |p|^2 + |c|^2 - 2 p.c as an
    add, a multiply and a subtract, the compare and the select); the squared
    norms are per pixel or per centre and left out.  Bytes: the float32
    features (B, MP, 5) and centres (B, K, 5) read once, the int32 ids
    (B, MP) written once, and for the expanded form the (B, K) validity
    bytes."""
    pairs = b * mp * k
    nbytes = 4 * (b * mp * 5 + b * k * 5 + b * mp)
    if form == "direct":
        return 17 * pairs, nbytes
    if form == "expanded":
        return 15 * pairs, nbytes + b * k
    raise ValueError(f"unknown slic_assign form {form!r}")
