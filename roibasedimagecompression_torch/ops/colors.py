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


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device, as XLA's.

    PyTorch's CPU kernel (SLEEF's 0.5-ulp sqrt) misses the correctly rounded
    result for a few inputs in a thousand; the square root of a float32 in
    float64, rounded to float32, is the correctly rounded one."""
    return torch.sqrt(x.double()).float()


def div32(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d in float32, a true division on every device: PyTorch's CUDA
    kernel computes a division by a Python scalar as a product with the
    scalar's reciprocal, so the divisor goes in as a tensor."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def _f32(x) -> float:
    return float(np.float32(x))


_TINY32 = float(np.finfo(np.float32).tiny)


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


# glibc's powf (2.28 and later, the code XLA's CPU backend calls for a float32
# `pow`, and for `cbrt` as powf(|x|, float32(1/3))): log2 from a 16-entry
# table and a degree-5 polynomial, exp2 from a 32-entry table and a degree-3
# polynomial, all in float64, rounded to float32 at the end.  The tables and
# coefficients are glibc's own.
_POWF_LOG2 = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
))
_POWF_A = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0",
))
_EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1",
))
_EXP2F_T = tuple(float.fromhex(h) for h in (  # 2^(i/32)
    "0x1.0000000000000p+0",
    "0x1.059b0d3158574p+0",
    "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0",
    "0x1.172b83c7d517bp+0",
    "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0",
    "0x1.29e9df51fdee1p+0",
    "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0",
    "0x1.3dea64c123422p+0",
    "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0",
    "0x1.5342b569d4f82p+0",
    "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0",
    "0x1.6a09e667f3bcdp+0",
    "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0",
    "0x1.82589994cce13p+0",
    "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0",
    "0x1.9c49182a3f090p+0",
    "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0",
    "0x1.b7f76f2fb5e47p+0",
    "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0",
    "0x1.d5818dcfba487p+0",
    "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0",
    "0x1.f50765b6e4540p+0",
))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")  # rounds to a multiple of 1/32


def powf32(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc's powf(x, y) for positive normal float32 x and a float32 y whose
    x ** y stays a normal float, bit for bit, on the CPU and on the card (its
    float64 steps in plain float64: a fused multiply-add there would move the
    float32 result only where the float64 one lies within 2^-53 of a float32
    midpoint)."""
    dev = x.device
    ix = x.float().view(torch.int32).long()
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = tmp & -0x800000
    z = (ix - top).int().view(torch.float32).double()
    tab = torch.tensor(_POWF_LOG2, dtype=torch.float64, device=dev)
    a = _POWF_A
    r = z * tab[i, 0] - 1.0
    y0 = tab[i, 1] + (top >> 23).double()
    r2 = r * r
    q = (a[2] * r + a[3]) * r2 + (a[4] * r + y0)
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    xd = float(np.float32(y)) * logx
    kd = (xd + _EXP2F_SHIFT) - _EXP2F_SHIFT
    r = xd - kd
    n = (kd * 32.0).long()
    s = torch.ldexp(torch.tensor(_EXP2F_T, dtype=torch.float64, device=dev)[n & 31], (n >> 5).double())
    c = _EXP2F_C
    return (((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s).float()


def _lab_f(rgb: torch.Tensor):
    """The CIELAB f(X/Xn), f(Y/Yn), f(Z/Zn) of uint8 RGB, float32, with the
    arithmetic of XLA's CPU code for the JAX package's rgb_to_lab, bit for
    bit: XLA's folded constants (read from its optimized HLO), glibc's powf,
    and Eigen's 3x3 product (rows X and Y added in order, row Z a fused
    chain)."""
    v = rgb.float()
    s = v * _INV255
    linear = torch.where(
        s > 0.04045,
        powf32((s + 0.055) * _f32("0.947867334"), 2.4),  # / 1.055
        v * _f32("0.000303527"),  # / 255 / 12.92
    )
    l0, l1, l2 = linear[..., 0], linear[..., 1], linear[..., 2]
    m = [[_f32(c) for c in row] for row in _RGB2XYZ]
    xyz = (
        (l0 * m[0][0] + l1 * m[0][1]) + l2 * m[0][2],
        (l0 * m[1][0] + l1 * m[1][1]) + l2 * m[1][2],
        fma32(l2, m[2][2], fma32(l1, m[2][1], l0 * m[2][0])),
    )
    out = []
    for x, inv_ref in zip(xyz, ("1.05211115", "1", "0.918417037")):  # / _XYZ_REF
        t = x * _f32(inv_ref)
        f = torch.where(
            t > 0.008856,
            powf32(t.clamp_min(_TINY32), _f32(1.0 / 3.0)),
            fma32(t, _f32(7.787), _f32("0.137931034")),
        )
        out.append(f)
    return out


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """skimage.color.rgb2lab for uint8 RGB -> float32 (..., 3) Lab; the JAX
    package's bits on the CPU and on the card."""
    fx, fy, fz = _lab_f(rgb)
    L = fma32(fy, 116.0, -16.0)
    a = (fx - fy) * 500.0
    b = (fy - fz) * 200.0
    return torch.stack([L, a, b], dim=-1)


# The 8-bit conversions below are the enhancer's (models/enhance.py).  The
# JAX package's enhancer calls them op by op, not jitted, so each jnp op is
# its own XLA computation: every step rounded alone (no fused multiply-adds,
# no folded reciprocals: a division by a Python scalar is a true division),
# `pow` and `cbrt` through glibc's powf, and the 3x3 products in Eigen's order
# (rows 0 and 1 added in order, row 2 a fused chain), as in `_lab_f`.  Over
# all 2^24 inputs of each direction they equal the JAX functions called so,
# bit for bit (tests/test_torch_eval.py).  The same functions jitted alone
# differ from that in 465 and 243 inputs: XLA fuses them otherwise.

def _dot3(v, m, j: int) -> torch.Tensor:
    """Row j of a float32 3x3 product of v (..., 3) with m, in Eigen's order."""
    a, b, c = (float(np.float32(m[j][k])) for k in range(3))
    if j < 2:
        return (v[0] * a + v[1] * b) + v[2] * c
    return fma32(v[2], c, fma32(v[1], b, v[0] * a))


def rgb_to_lab_cv2(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(..., COLOR_RGB2LAB) for uint8: 8-bit scaled CIELAB, L
    mapped to 0..255 (L * 255/100), a and b offset by +128; uint8."""
    s = div32(rgb.float(), 255.0)
    linear = torch.where(s > _f32(0.04045), powf32(div32(s + _f32(0.055), 1.055), 2.4),
                         div32(s, 12.92))
    lin = (linear[..., 0], linear[..., 1], linear[..., 2])
    f = []
    for j in range(3):
        t = div32(_dot3(lin, _RGB2XYZ, j), _XYZ_REF[j])
        cube_root = powf32(t.clamp_min(_TINY32), 1.0 / 3.0)
        f.append(torch.where(t > _f32(0.008856), cube_root,
                             t * _f32(7.787) + _f32(16.0 / 116.0)))
    L = (f[1] * 116.0 - 16.0) * _f32(255.0 / 100.0)
    a = (f[0] - f[1]) * 500.0 + 128.0
    b = (f[1] - f[2]) * 200.0 + 128.0
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
    fy = div32(x[..., 0] * _f32(100.0 / 255.0) + 16.0, 116.0)
    fx = fy + div32(x[..., 1] - 128.0, 500.0)
    fz = fy - div32(x[..., 2] - 128.0, 200.0)
    eps = _f32(6.0 / 29.0)

    def inv_f(f):
        return torch.where(f > eps, f * (f * f), div32(f - _f32(16.0 / 116.0), 7.787))

    xyz = (inv_f(fx) * _f32(_XYZ_REF[0]), inv_f(fy), inv_f(fz) * _f32(_XYZ_REF[2]))
    m = [_XYZ2RGB[3 * j : 3 * j + 3] for j in range(3)]
    linear = torch.stack([_dot3(xyz, m, j) for j in range(3)], dim=-1)
    s = torch.where(
        linear > _f32(0.0031308),
        powf32(torch.clamp_min(linear, _f32(1e-12)), 1.0 / 2.4) * _f32(1.055) - _f32(0.055),
        linear * _f32(12.92),
    )
    return torch.clamp(torch.round(s * 255.0), 0, 255).to(torch.uint8)
