"""Edge-preserving bilateral filter (a decoder-side post-processing helper).

The counterpart of the JAX package's `ops/bilateral.py` (cv2.bilateralFilter
of the reference's optional reconstruction smoother): Gaussian spatial
weights times Gaussian range weights over the taps of a circular window
(dr^2 + dc^2 <= r^2) of an edge-padded image.  It follows the jitted JAX
function's CPU arithmetic: both Gaussians through XLA's float32 `exp` (its
own polynomial, `exp32`), the scales 1 / (2 sigma^2) rounded as XLA computes
them from the traced sigmas, each tap's product fused into the running
numerator (the first two taps as one fused multiply-add), the denominator
added in tap order, then a true division and round-half-even.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32
from roibasedimagecompression_torch.ops.prng import _hex32

_EXP_LO, _EXP_HI = _hex32("-0x1.5f3334p+6"), _hex32("0x1.633334p+6")
_TINY = float(np.finfo(np.float32).tiny)
_LOG2E = _hex32("0x1.715476p+0")
_LN2_HI, _LN2_LO = _hex32("0x1.630000p-1"), _hex32("-0x1.bd0106p-13")
_P = [_hex32(h) for h in ("0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7",
                           "0x1.555382p-5", "0x1.555554p-3")]


def exp32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 `exp`, bit for bit: a Cephes `expf` (clamp, split
    x = n ln2 + r with ln 2 in two parts, a degree-7 polynomial in r by fused
    multiply-adds, times 2^n built from the exponent bits, 0 at n = -127);
    a subnormal result is flushed to zero, as XLA's CPU code runs."""
    x = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma32(-n, _LN2_LO, fma32(-n, _LN2_HI, x))
    y = fma32(r, _P[0], _P[1])
    for c in (_P[2], _P[3], _P[4], 0.5):
        y = fma32(y, r, c)
    y = fma32(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < _TINY, torch.zeros((), device=out.device), out)


def _inv_two_sq(sigma: float, device) -> torch.Tensor:
    """float32 1 / (sigma * (2 sigma)), a true division, as XLA computes it."""
    s = torch.tensor(sigma, dtype=torch.float32, device=device)
    return torch.ones((), dtype=torch.float32, device=device) / (s * (s * 2.0))


def bilateral_filter(image: torch.Tensor, diameter: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """(h, w, 3) uint8 -> (h, w, 3) uint8 bilateral-smoothed, on the image's
    device."""
    x = image.float()
    h, w, _ = x.shape
    r = diameter // 2
    pad = torch.nn.functional.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0]
    pad = pad.permute(1, 2, 0)
    inv_ss = _inv_two_sq(sigma_space, x.device)
    inv_sc = _inv_two_sq(sigma_color, x.device)
    terms, dens = [], []
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            if dr * dr + dc * dc > r * r:
                continue
            shifted = pad[r + dr : r + dr + h, r + dc : r + dc + w]
            s_w = exp32(torch.tensor(-float(dr * dr + dc * dc), device=x.device) * inv_ss)
            d = shifted - x
            d2 = (d * d).sum(dim=2)  # integers below 2^24: exact in any order
            wt = s_w * exp32(-d2 * inv_sc)
            terms.append((shifted, wt[..., None]))
            dens.append(wt)
    (s0, w0), (s1, w1) = terms[0], terms[1]
    num = fma32(s0, w0, s1 * w1)
    for s, wt in terms[2:]:
        num = fma32(s, wt, num)
    den = dens[0]
    for wt in dens[1:]:
        den = den + wt
    out = num / torch.clamp(den, min=1e-12)[..., None]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
