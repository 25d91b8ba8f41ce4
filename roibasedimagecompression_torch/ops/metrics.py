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

from roibasedimagecompression_torch.utils import device as DEV


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    m = mse(a, b)
    inf = torch.full_like(m, float("inf"))
    return torch.where(m > 0, 10.0 * torch.log10(data_range * data_range / m), inf)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over a win x win box, 'valid' output, of (C, H, W) planes.

    The JAX filter is a convolution with float32(1/win^2) weights at full
    float32 precision; here each window's products with that weight are
    summed, in bands of rows so the (C, rows, W, win, win) products stay
    small.  Against the JAX `ssim` on the CPU this agrees to 1.1e-6 in the
    mean and 2.0e-4 at a pixel of the map, where `F.conv2d` with the same
    weights reaches 5.6e-6 / 4.0e-4 and average pooling 3.2e-6 / 3.4e-4
    (the cases of tests/test_torch_eval.py).  No step rounds to TF32."""
    weight = float(np.float32(1.0 / (win * win)))
    c, h, w = x.shape
    h_out = h - win + 1
    band = max(1, (1 << 24) // max(1, c * w * win * win))
    out = [
        (x[:, r : r + band + win - 1].unfold(1, win, 1).unfold(2, win, 1) * weight).sum(dim=(-1, -2))
        for r in range(0, h_out, band)
    ]
    return torch.cat(out, dim=1)


def _ssim_planes(a: torch.Tensor, b: torch.Tensor, data_range: float, win_size: int,
                 k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-pixel SSIM of (C, H, W) planes over the region where the window
    fits: uniform filter, sample covariance NP / (NP - 1)."""
    a = a.float()
    b = b.float()
    np_pts = float(win_size * win_size)
    cov_norm = np_pts / (np_pts - 1.0)
    # Centre each plane pair by its joint mean before filtering: the variance
    # terms are uxx - ux^2 of large numbers, and smaller magnitudes keep the
    # float32 cancellation error negligible against C2.  The (co)variances are
    # shift-invariant; the mean terms are un-shifted below.
    shift = 0.5 * (a.mean(dim=(1, 2), keepdim=True) + b.mean(dim=(1, 2), keepdim=True))
    a = a - shift
    b = b - shift
    ux = _uniform_filter_valid(a, win_size)
    uy = _uniform_filter_valid(b, win_size)
    vx = cov_norm * (_uniform_filter_valid(a * a, win_size) - ux * ux)
    vy = cov_norm * (_uniform_filter_valid(b * b, win_size) - uy * uy)
    vxy = cov_norm * (_uniform_filter_valid(a * b, win_size) - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ux = ux + shift
    uy = uy + shift
    return ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))


def _planes(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 2 else x.permute(2, 0, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7) -> torch.Tensor:
    """SSIM of (h, w) or (h, w, c) images; channels averaged like skimage."""
    return _ssim_planes(_planes(a), _planes(b), data_range, win_size).mean(dim=(1, 2)).mean()


def ssim_map(a: np.ndarray, b: np.ndarray, data_range: float = 255.0, win_size: int = 7,
             device=None) -> np.ndarray:
    """Per-pixel SSIM map of two (h, w) or (h, w, c) images, averaged over
    channels and padded back to (h, w) by repeating the nearest interior
    value (skimage's full=True map, which the comparison figure shows).
    Computed on `device` (None: CUDA); returns float32 numpy."""
    dev = DEV.resolve(device)
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    ta = torch.from_numpy(np.array(a)).to(dev).permute(2, 0, 1)
    tb = torch.from_numpy(np.array(b)).to(dev).permute(2, 0, 1)
    maps = _ssim_planes(ta, tb, data_range, win_size).cpu().numpy()
    return np.pad(np.mean(maps, axis=0), win_size // 2, mode="edge")


def quality_metrics(original: np.ndarray, reconstructed: np.ndarray, device=None) -> dict:
    """Metric dict (mse, psnr, ssim, rmse, mae, max_error, mse_r/g/b) of two
    (h, w, 3) uint8 images, computed on `device` (None: CUDA)."""
    dev = DEV.resolve(device)
    a = torch.from_numpy(np.array(original)).to(dev)
    b = torch.from_numpy(np.array(reconstructed)).to(dev)
    err = a.float() - b.float()
    m = torch.mean(err * err)
    out = {
        "mse": m, "psnr": psnr(a, b), "ssim": ssim(a, b), "rmse": torch.sqrt(m),
        "mae": err.abs().mean(), "max_error": err.abs().max(),
    }
    result = {k: float(v) for k, v in out.items()}
    for name, v in zip("rgb", torch.mean(err * err, dim=(0, 1)).tolist()):
        result[f"mse_{name}"] = float(v)
    return result
