"""Image quality metrics (MSE / PSNR / SSIM) as torch ops.

The counterpart of the JAX package's `ops/metrics.py`: PSNR with
data_range=255, SSIM as skimage computes it (7x7 uniform window, sample
covariance normalization, K1=0.01 / K2=0.03, per channel and averaged).
Inputs are tensors on any device; `quality_metrics` and `ssim_map` take
numpy images and a device.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops import prng
from roibasedimagecompression_torch.ops import xla_order as XO
from roibasedimagecompression_torch.ops.colors import fma32, sqrt32
from roibasedimagecompression_torch.utils import device as DEV


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    m = mse(a, b)
    inf = torch.full_like(m, float("inf"))
    return torch.where(m > 0, 10.0 * torch.log10(data_range * data_range / m), inf)


# ---------------------------------------------------------------------------
# SSIM in the JAX package's CPU arithmetic, bit for bit.
#
# The 7x7 box filter is XLA's CPU convolution (Eigen's contraction of the
# image patches with the kernel, float32(1/49) each tap): taps 0-47 of the
# row-major window go into 8 lanes (tap t into lane t % 8) as fused
# multiply-adds, the lanes fold as ((l0 + l1) + (l4 + l5)) + ((l2 + l3) +
# (l6 + l7)), and the last tap's rounded product is added.  A sum over a
# map is XLA's tree reduction: 32 x 32 windows (centred padding) added in
# row-major order from zero, then the grid of window sums (both orders in
# `ops/xla_order.py`).  The JAX package's `ssim` runs op by op (every
# product and sum rounded); its jitted `ssim_map` and `quality_metrics`
# contract a product into the addition that consumes it, as XLA's fusions do
# (`_ssim_terms`), and `quality_metrics` folds each channel's mean into the
# channel sum as a fused multiply-add.  Every order above was read from
# XLA's dumps (optimized HLO, LLVM IR and the object code) and probes on an
# 8-thread host, and holds for any image size.
# ---------------------------------------------------------------------------

_WIN = 7


def _f32(v: float) -> float:
    return float(np.float32(v))


def _box_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """(N, H, W) float32 -> (N, H-win+1, W-win+1): the win x win mean,
    'valid' output, in XLA's CPU order (see above; read at win = 7)."""
    ho, wo = x.shape[1] - win + 1, x.shape[2] - win + 1
    wt = _f32(np.float32(1.0) / np.float32(win * win))
    taps = [x[:, dy : dy + ho, dx : dx + wo] for dy in range(win) for dx in range(win)]
    return XO.eigen_lanes(taps.__getitem__, range(len(taps)), weight=wt)


def _sum_channel_minor(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (C,): XLA's sum over H and W of an (H, W, C) array (the
    channel the minor dimension): windows, then the grid in one fold."""
    g = XO.reduce_windows(x)
    return XO.fold(g.reshape(g.shape[0], -1))


def _ssim_terms(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                data_range: float, win: int, fused: bool) -> torch.Tensor:
    """(N, Ho, Wo) SSIM map of (N, H, W) float32 planes whose sums are sa,
    sb (N,), with skimage's constants.  `fused`: XLA's jitted arithmetic
    (contracted multiply-adds, 2 * cov_norm folded), else op by op."""
    np_pts = float(win * win)
    cov_norm = _f32(np_pts / (np_pts - 1.0))
    c1, c2 = _f32((0.01 * data_range) ** 2), _f32((0.03 * data_range) ** 2)
    r = _f32(1.0 / (a.shape[1] * a.shape[2]))
    if fused:
        shift = (fma32(sa, r, sb * r) * 0.5)[:, None, None]
    else:
        shift = (0.5 * (sa * r + sb * r))[:, None, None]
    a = a - shift
    b = b - shift
    ux, uy = _box_valid(a, win), _box_valid(b, win)
    uxx, uyy, uxy = _box_valid(a * a, win), _box_valid(b * b, win), _box_valid(a * b, win)
    if fused:
        dx, dy, dxy = fma32(-ux, ux, uxx), fma32(-uy, uy, uyy), fma32(-ux, uy, uxy)
        ux = shift + ux
        uy = shift + uy
        a1 = fma32(ux * 2.0, uy, c1)
        a2 = fma32(dxy, _f32(2.0 * np_pts / (np_pts - 1.0)), c2)
        b1 = fma32(ux, ux, uy * uy) + c1
        b2 = fma32(dx, cov_norm, dy * cov_norm) + c2
    else:
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        ux = ux + shift
        uy = uy + shift
        a1 = (2.0 * ux) * uy + c1
        a2 = 2.0 * vxy + c2
        b1 = (ux * ux + uy * uy) + c1
        b2 = (vx + vy) + c2
    return (a1 * a2) / (b1 * b2)


def _planes(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 2 else x.permute(2, 0, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7) -> torch.Tensor:
    """SSIM of (h, w) or (h, w, c) images, channels averaged like skimage:
    the JAX package's `ssim` (op by op), bit for bit."""
    pa, pb = _planes(a).float(), _planes(b).float()
    sum_in = XO.sum_rows if a.dim() == 2 else _sum_channel_minor
    s = _ssim_terms(pa, pb, sum_in(pa), sum_in(pb), data_range, win_size, fused=False)
    per = XO.sum_rows(s) * _f32(1.0 / (s.shape[1] * s.shape[2]))
    if a.dim() == 2:
        return per[0]
    return XO.fold(per[None])[0] * _f32(1.0 / per.shape[0])


def ssim_map(a: np.ndarray, b: np.ndarray, data_range: float = 255.0, win_size: int = 7,
             device=None) -> np.ndarray:
    """Per-pixel SSIM map of two (h, w) or (h, w, c) images, averaged over
    channels and padded back to (h, w) by repeating the nearest interior
    value (skimage's full=True map, which the comparison figure shows): the
    JAX package's jitted map, one channel at a time, bit for bit.  Computed
    on `device` (None: CUDA); returns float32 numpy."""
    dev = DEV.resolve(device)
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    maps = []
    for c in range(a.shape[-1]):
        pa = torch.from_numpy(np.ascontiguousarray(a[..., c])).to(dev).float()[None]
        pb = torch.from_numpy(np.ascontiguousarray(b[..., c])).to(dev).float()[None]
        maps.append(_ssim_terms(pa, pb, XO.sum_rows(pa), XO.sum_rows(pb), data_range, win_size,
                                fused=True)[0].cpu().numpy())
    return np.pad(np.mean(maps, axis=0), win_size // 2, mode="edge")


def _ssim_jit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The SSIM of the JAX package's jitted `quality_metrics`."""
    pa, pb = _planes(a).float(), _planes(b).float()
    sum_in = XO.sum_rows if a.dim() == 2 else _sum_channel_minor
    s = _ssim_terms(pa, pb, sum_in(pa), sum_in(pb), 255.0, _WIN, fused=True)
    sums = XO.sum_rows(s)
    r = _f32(1.0 / (s.shape[1] * s.shape[2]))
    if a.dim() == 2:
        return sums[0] * r
    acc = torch.zeros((), dtype=torch.float32, device=s.device)
    for c in range(sums.shape[0]):
        acc = fma32(sums[c], r, acc)
    return acc * _f32(1.0 / sums.shape[0])


def _sum_all(x: torch.Tensor) -> torch.Tensor:
    """XLA's sum of every element of an (H, W, C) array: 32 x 32 x C
    windows (centred zero padding in H and W), then their grid as
    `XO.sum_rows` adds it.  A window adds row after row into its sum; LLVM
    vectorises a row of an unpadded window over 8 lanes (column w into lane
    w % 8, its C channels in turn; lane 0 starts from the window's sum, the
    lanes folded in halves), and adds a padded window's elements one after
    another."""
    h, w, c = x.shape
    wr, wc = min(h, XO.REDUCE_WINDOW), min(w, XO.REDUCE_WINDOW)
    pr, pc = (-h) % wr, (-w) % wc
    x = torch.nn.functional.pad(x, (0, 0, pc // 2, pc - pc // 2, pr // 2, pr - pr // 2))
    nr, nc = x.shape[0] // wr, x.shape[1] // wc
    v = x.reshape(nr, wr, nc, wc, c).permute(0, 2, 1, 3, 4)  # (nr, nc, row, col, channel)
    if pr or pc or wc % 8:
        return XO.sum_rows(XO.fold(v.reshape(1, nr, nc, wr * wc * c)))[0]
    # (nr, nc, row, lane, the lane's columns and channels in turn)
    v = v.reshape(nr, nc, wr, wc // 8, 8, c).permute(0, 1, 2, 4, 3, 5).reshape(nr, nc, wr, 8, -1)
    acc = torch.zeros((nr, nc), dtype=torch.float32, device=x.device)
    for row in range(wr):
        start = torch.zeros((nr, nc, 8, 1), dtype=torch.float32, device=x.device)
        start[:, :, 0, 0] = acc
        lanes = XO.fold(torch.cat([start, v[:, :, row]], dim=-1))
        acc = XO.halves(list(lanes.unbind(-1)))
    return XO.sum_rows(acc[None])[0]


# 10 / ln(10) as XLA folds it: float32(1 / ln 10) * 10, rounded.
_TEN_OVER_LN10 = _f32(np.float32(1.0 / np.log(10.0)) * np.float32(10.0))


def quality_metrics(original: np.ndarray, reconstructed: np.ndarray, device=None) -> dict:
    """Metric dict (mse, psnr, ssim, rmse, mae, max_error, mse_r/g/b) of two
    (h, w, 3) uint8 images, computed on `device` (None: CUDA): the JAX
    package's jitted `quality_metrics`, every value bit for bit (its sums in
    XLA's order, its `log` through `prng.log32`, a correctly rounded square
    root)."""
    dev = DEV.resolve(device)
    a = torch.from_numpy(np.array(original)).to(dev)
    b = torch.from_numpy(np.array(reconstructed)).to(dev)
    err = a.float() - b.float()
    h, w, c = err.shape
    r = _f32(1.0 / (h * w * c))
    sq = err * err
    m = _sum_all(sq) * r
    ratio = torch.tensor(255.0 * 255.0, device=dev) / m  # a true division
    db = prng.log32(ratio.reshape(1))[0] * _TEN_OVER_LN10
    out = {
        "mse": m, "psnr": torch.where(m > 0, db, torch.full_like(m, float("inf"))),
        "ssim": _ssim_jit(a, b), "rmse": sqrt32(m), "mae": _sum_all(err.abs()) * r,
        "max_error": err.abs().max(),
    }
    result = {k: float(v) for k, v in out.items()}
    per_channel = _sum_channel_minor(sq.permute(2, 0, 1)) * _f32(1.0 / (h * w))
    for name, v in zip("rgb", per_channel.tolist()):
        result[f"mse_{name}"] = float(v)
    return result
