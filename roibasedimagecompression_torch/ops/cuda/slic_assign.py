"""SLIC assign: nearest 5-D centre per pixel (kernel `csrc/slic_assign.cu`).

The counterpart of the JAX package's Pallas `slic_assign_pallas`.  On a CUDA
tensor `slic_assign` launches the kernel (or raises); on a CPU tensor it runs
the plain PyTorch version `slic_assign_ref`, which rounds the distance where
the kernel does and takes the first-index argmin.

The distance is the JAX kernel's as XLA compiles it for the CPU: the sum
`d2 + diff*diff` over the five dimensions is contracted into fused
multiply-adds, except the product of dimension 1, which is rounded on its own
before dimension 0 is fused onto it (both operands of that first add are
products, and the left one is fused).  With this arithmetic the ids equal
`slic_assign_pallas(interpret=True)` without a tie allowance.
"""

from __future__ import annotations

import collections
import threading

import torch

from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.cuda import _build

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launch_shapes: collections.Counter = collections.Counter()  # (B, MP, K) of every launch
_count_lock = threading.Lock()  # encode_stream launches from several threads


def slic_assign_ref(feats: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, MP, 5) f32 x (B, K, 5) f32 -> (B, MP) int32."""
    out = torch.empty(feats.shape[:2], dtype=torch.int32, device=feats.device)
    # Pixel chunks bound the (B, chunk, K) distance block; each pixel's id
    # depends on its own row only, so chunking does not change the result.
    chunk = max(1, (1 << 22) // max(1, feats.shape[0] * centers.shape[1]))
    for s in range(0, feats.shape[1], chunk):
        f = feats[:, s : s + chunk]
        diff = f[..., 1, None] - centers[:, None, :, 1]
        d2 = diff * diff
        for d in (0, 2, 3, 4):
            diff = f[..., d, None] - centers[:, None, :, d]
            d2 = fma32(diff, diff, d2)
        out[:, s : s + chunk] = torch.argmin(d2, dim=2).int()
    return out


def slic_assign(feats: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre ids (B, MP) int32 for feats (B, MP, 5) and centres
    (B, K, 5), K <= 256, both float32."""
    global launches
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
    if feats.device.type == "cpu":
        return slic_assign_ref(feats, centers)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not (feats.is_contiguous() and centers.is_contiguous()):
        raise ValueError("slic_assign takes contiguous tensors")
    lib = _build.load("slic_assign")
    b, mp, _ = feats.shape
    out = torch.empty((b, mp), dtype=torch.int32, device=feats.device)
    _build.launch(lib, "slic_assign_launch", feats.device, feats.data_ptr(), centers.data_ptr(),
                  out.data_ptr(), b, mp, centers.shape[1])
    with _count_lock:
        launches += 1
        launch_shapes[(b, mp, centers.shape[1])] += 1
    return out
