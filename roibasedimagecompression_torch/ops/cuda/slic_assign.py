"""SLIC assign: nearest 5-D centre per pixel (kernel `csrc/slic_assign.cu`).

Two distance forms, as in the JAX package's `ops/slic.py`, each with its
plain PyTorch version; on a CUDA tensor the wrapper launches the kernel (or
raises), on a CPU tensor it runs the plain version, which rounds the distance
where the kernel does and takes the first-index argmin.

`slic_assign` is the direct form of the Pallas `slic_assign_pallas`
(`RHCCQ_SLIC_PALLAS=1`), as XLA compiles it for the CPU: the sum `d2 +
diff*diff` over the five dimensions is contracted into fused multiply-adds,
except the product of dimension 1, which is rounded on its own before
dimension 0 is fused onto it (both operands of that first add are products,
and the left one is fused).  With this arithmetic the ids equal
`slic_assign_pallas(interpret=True)` without a tie allowance.

`slic_assign_expanded` is the JAX package's default, `|p|^2 + |c|^2 - 2 p.c`
at `Precision.HIGHEST` with invalid centres masked to never win.  On the CPU
XLA computes each squared norm as a reduce of rounded products added in
order, the dot as Eigen's fused multiply-add chain over the 5-deep
contraction, and `(p2 + c2) - 2 dot` with two roundings; the plain version
follows that and equals XLA's distances bit for bit.
"""

from __future__ import annotations

import torch

from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.cuda import _build
from roibasedimagecompression_torch.utils import flops as FLOPS

FORMS = ("direct", "expanded")
launch_shapes = _build.launched["slic_assign"]  # (form, B, MP, K) -> launches


def _check(feats: torch.Tensor, centers: torch.Tensor) -> None:
    if feats.dim() != 3 or centers.dim() != 3 or feats.shape[2] != 5 or centers.shape[2] != 5:
        raise ValueError(f"expected (B, MP, 5) and (B, K, 5), got {tuple(feats.shape)}, {tuple(centers.shape)}")
    if feats.shape[0] != centers.shape[0]:
        raise ValueError("feats and centers disagree on the batch size")
    if feats.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError("slic_assign takes float32 tensors")
    if centers.shape[1] > 256 or centers.shape[1] < 1:
        raise ValueError(f"K must be in [1, 256], got {centers.shape[1]}")
    if feats.device != centers.device:
        raise ValueError("feats and centers are on different devices")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    if feats.device.type == "cuda" and not (feats.is_contiguous() and centers.is_contiguous()):
        raise ValueError("slic_assign takes contiguous tensors")


def _chunked_argmin(feats: torch.Tensor, k: int, d2_of) -> torch.Tensor:
    """First-index argmin over K of d2_of(pixel slice), in pixel chunks that
    bound the (B, chunk, K) distance block; each pixel's id depends on its own
    row only, so chunking does not change the result."""
    out = torch.empty(feats.shape[:2], dtype=torch.int32, device=feats.device)
    chunk = max(1, (1 << 22) // max(1, feats.shape[0] * k))
    for s in range(0, feats.shape[1], chunk):
        out[:, s : s + chunk] = torch.argmin(d2_of(feats[:, s : s + chunk]), dim=2).int()
    return out


def slic_assign_ref(feats: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Plain version of the direct form: (B, MP, 5) f32 x (B, K, 5) f32 ->
    (B, MP) int32."""

    def d2_of(f):
        diff = f[..., 1, None] - centers[:, None, :, 1]
        d2 = diff * diff
        for d in (0, 2, 3, 4):
            diff = f[..., d, None] - centers[:, None, :, d]
            d2 = fma32(diff, diff, d2)
        return d2

    return _chunked_argmin(feats, centers.shape[1], d2_of)


def sq_norm5(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last dimension (5) as XLA's CPU reduce computes it: each
    product rounded, then added in order."""
    s = x[..., 0] * x[..., 0]
    for d in range(1, x.shape[-1]):
        s = s + x[..., d] * x[..., d]
    return s


def slic_assign_expanded_ref(feats: torch.Tensor, centers: torch.Tensor,
                             center_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the expanded form: (B, MP, 5) f32 x (B, K, 5) f32,
    (B, K) bool -> (B, MP) int32; a centre that is not valid never wins."""
    inf = torch.tensor(float("inf"), device=centers.device)
    c2 = torch.where(center_valid, sq_norm5(centers), inf)[:, None, :]

    def d2_of(f):
        p2 = sq_norm5(f)[..., None]
        fe, ce = f[:, :, None, :], centers[:, None, :, :]
        dot = fe[..., 0] * ce[..., 0]
        for d in range(1, 5):
            dot = fma32(fe[..., d], ce[..., d], dot)
        return (p2 + c2) - 2.0 * dot

    return _chunked_argmin(feats, centers.shape[1], d2_of)


def slic_assign(feats: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Direct form: nearest-centre ids (B, MP) int32 for feats (B, MP, 5) and
    centres (B, K, 5), K <= 256, both float32; invalid centres carry a large
    sentinel."""
    _check(feats, centers)
    if feats.device.type == "cpu":
        return slic_assign_ref(feats, centers)
    b, mp, _ = feats.shape
    k = centers.shape[1]
    out = torch.empty((b, mp), dtype=torch.int32, device=feats.device)
    _build.launch("slic_assign", "slic_assign_launch", feats.device, feats.data_ptr(),
                  centers.data_ptr(), out.data_ptr(), b, mp, k, key=("direct", b, mp, k))
    FLOPS.add(17 * b * mp * k, 4 * (b * mp * 5 + b * k * 5 + b * mp))
    return out


def slic_assign_expanded(feats: torch.Tensor, centers: torch.Tensor,
                         center_valid: torch.Tensor) -> torch.Tensor:
    """Expanded form: nearest-centre ids (B, MP) int32 for feats (B, MP, 5)
    and centres (B, K, 5), K <= 256, both float32, and center_valid (B, K)
    bool."""
    _check(feats, centers)
    if tuple(center_valid.shape) != tuple(centers.shape[:2]) or center_valid.dtype != torch.bool:
        raise ValueError("center_valid must be (B, K) bool")
    if center_valid.device != feats.device:
        raise ValueError("center_valid is on another device")
    if feats.device.type == "cpu":
        return slic_assign_expanded_ref(feats, centers, center_valid)
    b, mp, _ = feats.shape
    k = centers.shape[1]
    valid_u8 = center_valid.to(torch.uint8).contiguous()
    out = torch.empty((b, mp), dtype=torch.int32, device=feats.device)
    _build.launch("slic_assign", "slic_assign_expanded_launch", feats.device, feats.data_ptr(),
                  centers.data_ptr(), valid_u8.data_ptr(), out.data_ptr(), b, mp, k,
                  key=("expanded", b, mp, k))
    FLOPS.add(15 * b * mp * k, 4 * (b * mp * 5 + b * k * 5 + b * mp) + b * k)
    return out
