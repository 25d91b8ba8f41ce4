"""Color space conversions as torch ops on (..., 3) uint8 tensors.

rgb_to_lab reproduces skimage.color.rgb2lab (sRGB -> linear -> XYZ D65 ->
CIELAB); rgb_to_gray_skimage is skimage's rgb2gray and rgb_to_gray_cv2 is
OpenCV's BT.601 gray (the Canny input).

The JAX package runs these through XLA on the CPU, which rewrites a division
by a constant into a multiplication by its float32 reciprocal and contracts
`a*b + c` into a fused multiply-add.  Where a later step compares values
exactly (the LBP codes and the intensity histogram of the split score read the
gray image), this module reproduces that arithmetic with `fma32`, so the bits
match; elsewhere plain float32 is within a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch


def fma32(a, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (XLA's contracted multiply-add).

    The product of two float32 values is exact in float64, so the float64
    sum rounded to float32 is the fused result (up to a double rounding that
    is vanishingly rare for these magnitudes).
    """
    a64 = a.double() if torch.is_tensor(a) else float(a)
    b64 = b.double() if torch.is_tensor(b) else float(b)
    c64 = c.double() if torch.is_tensor(c) else float(c)
    return (a64 * b64 + c64).float()


def _f32(x: float) -> float:
    return float(np.float32(x))


_INV255 = _f32(1.0 / 255.0)


def rgb_to_gray_cv2(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(..., COLOR_RGB2GRAY): 0.299 R + 0.587 G + 0.114 B rounded
    (half to even) back to uint8.  The sum is rounded where XLA's CPU code
    rounds it, which decides the exact .5 cases: equal to the JAX function on
    all 2^24 colors."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = fma32(_f32(0.114), b, fma32(_f32(0.299), r, _f32(0.587) * g))
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def rgb_to_gray_skimage(rgb: torch.Tensor) -> torch.Tensor:
    """skimage.color.rgb2gray on uint8: float32 in [0, 1],
    weights 0.2125 / 0.7154 / 0.0721."""
    x = rgb.float() * _INV255
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return fma32(_f32(0.0721), b, fma32(_f32(0.2125), r, _f32(0.7154) * g))


_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ_REF = (0.95047, 1.0, 1.08883)


def _pow32(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """float32 x ** exponent through float64, rounded once.

    The float32 `pow` of the CPU and of the card differ in the last bit for
    about one value in six, which is enough to move a SLIC label and, through
    a palette that gains or loses one color, every later draw of the k-means.
    Both libraries' float64 `pow` is within an ulp of float64, far below
    float32's spacing, so the rounded result is the same on both (and is the
    correctly rounded power but for one value in 2^28)."""
    return torch.pow(x.double(), exponent).float()


def _lab_f(rgb: torch.Tensor):
    """The CIELAB f(X/Xn), f(Y/Yn), f(Z/Zn) of uint8 RGB, float32."""
    s = rgb.float() * _INV255
    linear = torch.where(
        s > 0.04045,
        _pow32((s + 0.055) * _f32(1.0 / 1.055), 2.4),
        s * _f32(1.0 / 12.92),
    )
    l0, l1, l2 = linear[..., 0], linear[..., 1], linear[..., 2]
    out = []
    for row, ref in zip(_RGB2XYZ, _XYZ_REF):
        xyz = l0 * _f32(row[0]) + l1 * _f32(row[1]) + l2 * _f32(row[2])
        t = xyz * _f32(1.0 / ref) if ref != 1.0 else xyz
        f = torch.where(
            t > 0.008856,
            _pow32(t.clamp_min(0.0), 1.0 / 3.0),
            t * 7.787 + _f32(16.0 / 116.0),
        )
        out.append(f)
    return out


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """skimage.color.rgb2lab for uint8 RGB -> float32 (..., 3) Lab; the same
    bits on the CPU and on the card."""
    fx, fy, fz = _lab_f(rgb)
    L = fy * 116.0 - 16.0
    a = (fx - fy) * 500.0
    b = (fy - fz) * 200.0
    return torch.stack([L, a, b], dim=-1)


# XLA's CPU code calls glibc's `powf` (and takes `cbrt` as powf(|x|,
# float32(1/3))), which is not correctly rounded; _pow32 is.  So the two 8-bit
# Lab conversions below differ from the JAX functions by one unit on a few
# inputs, measured over all 2^24 of them: 491 colours for rgb_to_lab_cv2, 108
# Lab triples for lab_cv2_to_rgb (tests/test_torch_eval.py holds a sample).

def rgb_to_lab_cv2(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(..., COLOR_RGB2LAB) for uint8: 8-bit scaled CIELAB, L
    mapped to 0..255 (L * 255/100), a and b offset by +128; uint8."""
    fx, fy, fz = _lab_f(rgb)
    L = fma32(fy, 116.0, -16.0) * _f32(255.0 / 100.0)
    a = fma32(fx - fy, 500.0, 128.0)
    b = fma32(fy - fz, 200.0, 128.0)
    return torch.clamp(torch.round(torch.stack([L, a, b], dim=-1)), 0, 255).to(torch.uint8)


# inverse(_RGB2XYZ) as the JAX package computes it in float32 (LU on the
# CPU), to the bit.
_XYZ2RGB = tuple(float.fromhex(h) for h in (
    "0x1.9ec816p+1", "-0x1.8982c2p+0", "-0x1.fe804ep-2",
    "-0x1.f0422ap-1", "0x1.e040e0p+0", "0x1.546d14p-5",
    "0x1.c7db6cp-5", "-0x1.a1e06ap-3", "0x1.0eabf0p+0",
))


def lab_cv2_to_rgb(lab_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_lab_cv2: 8-bit Lab -> uint8 RGB."""
    x = lab_u8.float()
    fy = fma32(x[..., 0], _f32(100.0 / 255.0), 16.0) * _f32(1.0 / 116.0)
    fx = fma32(x[..., 1] - 128.0, _f32(1.0 / 500.0), fy)
    fz = fma32(128.0 - x[..., 2], _f32(1.0 / 200.0), fy)
    eps = _f32(6.0 / 29.0)

    def inv_f(f):
        return torch.where(f > eps, (f * f) * f, (f - _f32(16.0 / 116.0)) * _f32(1.0 / 7.787))

    xyz = (inv_f(fx) * _f32(_XYZ_REF[0]), inv_f(fy), inv_f(fz) * _f32(_XYZ_REF[2]))
    linear = torch.stack([
        fma32(xyz[2], _XYZ2RGB[3 * j + 2], fma32(xyz[1], _XYZ2RGB[3 * j + 1], xyz[0] * _XYZ2RGB[3 * j]))
        for j in range(3)
    ], dim=-1)
    s = torch.where(
        linear > 0.0031308,
        fma32(_f32(1.055), _pow32(torch.clamp_min(linear, 1e-12), 1 / 2.4), _f32(-0.055)),
        linear * 12.92,
    )
    return torch.clamp(torch.round(s * 255.0), 0, 255).to(torch.uint8)
