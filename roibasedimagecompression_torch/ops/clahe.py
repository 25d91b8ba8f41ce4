"""CLAHE (contrast-limited adaptive histogram equalisation) as torch ops.

`clahe_1d` is the shadow enhancer's CLAHE: the shadow pixels gathered into
one n x 1 column, which with a 16 x 16 tile grid is 1-D CLAHE over 16 row
tiles.  `clahe_2d` is the standard tiled CLAHE of a gray image.  Both take
uint8 tensors on any device and return uint8 on the same device.

The histograms are integer counts; the LUTs are float32 running sums of
the clipped counts, as in the JAX function.  The interpolation rounds as
XLA's CPU code rounds it: a division by a tile size is a multiplication by
its float32 reciprocal fused with the -0.5, and in a sum of two products the
first is fused with the second's rounded value.  Equal to the JAX functions
on every one of 40 random cases of each (tests/test_torch_eval.py holds
seven).
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32


def _clipped_cdf_lut(hist: torch.Tensor, clip_limit_abs: float, n_pixels: int) -> torch.Tensor:
    """Per-tile LUTs of (T, 256) histograms: clip, spread the excess evenly,
    scale the CDF to 0..255 (cv2's CLAHE)."""
    clipped = torch.clamp(hist, max=clip_limit_abs)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / 256.0, dim=-1)
    scale = torch.tensor(255.0, device=hist.device) / float(max(n_pixels, 1))
    return torch.clamp(torch.round(cdf * scale), 0, 255)


def _tile_hists(tiles: torch.Tensor) -> torch.Tensor:
    """(T, P) int64 values 0..255 -> (T, 256) float32 counts."""
    t = tiles.shape[0]
    hist = torch.zeros((t, 256), dtype=torch.float32, device=tiles.device)
    return hist.scatter_add_(1, tiles, torch.ones(tiles.shape, dtype=torch.float32, device=tiles.device))


def _centre_pos(i: torch.Tensor, size: int) -> torch.Tensor:
    """i / size - 0.5: a pixel's position in tile units, tile centres at
    integers."""
    return fma32(i, float(np.float32(1.0 / size)), -0.5)


def clahe_1d(values: torch.Tensor, clip_limit: float = 3.0, n_tiles: int = 16) -> torch.Tensor:
    """1-D CLAHE over a uint8 vector, n_tiles row tiles, linear
    interpolation between neighbouring tile LUTs (cv2 on an n x 1 image)."""
    n = values.shape[0]
    dev = values.device
    v = values.long()
    tile_size = -(-n // n_tiles)
    pad = tile_size * n_tiles - n
    # cv2 pads with reflected border rows to a multiple of the grid.
    vp = torch.cat([v, torch.flip(v[n - pad - 1 : n - 1], dims=(0,))]) if pad else v
    clip_abs = max(clip_limit * tile_size / 256.0, 1.0)
    luts = _clipped_cdf_lut(_tile_hists(vp.reshape(n_tiles, tile_size)), clip_abs, tile_size)

    # Tile centres at (t + 0.5) * tile_size.
    pos = _centre_pos(torch.arange(n, dtype=torch.float32, device=dev), tile_size)
    t0 = torch.clamp(torch.floor(pos).long(), 0, n_tiles - 1)
    t1 = torch.clamp(t0 + 1, 0, n_tiles - 1)
    frac = torch.clamp(pos - t0.float(), 0.0, 1.0)
    out = fma32(luts[t0, v], 1.0 - frac, luts[t1, v] * frac)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def clahe_2d(gray: torch.Tensor, clip_limit: float = 3.0, grid: int = 8) -> torch.Tensor:
    """Standard 2-D tiled CLAHE over an (h, w) uint8 image."""
    h, w = gray.shape
    dev = gray.device
    th = -(-h // grid)
    tw = -(-w // grid)
    g = gray.long()
    gp = torch.nn.functional.pad(
        g[None, None].float(), (0, tw * grid - w, 0, th * grid - h), mode="reflect"
    )[0, 0].long()
    tiles = gp.reshape(grid, th, grid, tw).permute(0, 2, 1, 3).reshape(grid * grid, th * tw)
    clip_abs = max(clip_limit * th * tw / 256.0, 1.0)
    luts = _clipped_cdf_lut(_tile_hists(tiles), clip_abs, th * tw).reshape(grid, grid, 256)

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    py = _centre_pos(yy, th)
    px = _centre_pos(xx, tw)
    y0 = torch.clamp(torch.floor(py).long(), 0, grid - 1)
    x0 = torch.clamp(torch.floor(px).long(), 0, grid - 1)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(py - y0.float(), 0.0, 1.0)
    fx = torch.clamp(px - x0.float(), 0.0, 1.0)
    v00 = luts[y0, x0, g]
    v01 = luts[y0, x1, g]
    v10 = luts[y1, x0, g]
    v11 = luts[y1, x1, g]
    gy, gx = 1 - fy, 1 - fx
    out = fma32(v11 * fy, fx, fma32(v10 * fy, gx, fma32(v00 * gy, gx, (v01 * gy) * fx)))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
