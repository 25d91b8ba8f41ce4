"""Shadow enhancement pre-stage (CLAHE on dark LAB regions).

Pixels whose 8-bit-scaled L channel is below `shadow_threshold` form the
shadow mask; CLAHE runs over exactly those pixels gathered into a 1-D
sequence (an n x 1 column, which with a 16 x 16 tile grid is 1-D CLAHE),
then the enhanced L values scatter back and the image returns to RGB.  It is
an optional pre-stage of the encoder: `encode(enhance_shadows(img), cfg)`
(the CLI's `--enhance-shadows`).

numpy images in and out; the colour conversions and CLAHE run on `device`
(None: CUDA, "cpu" for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops import clahe as CL
from roibasedimagecompression_torch.ops import colors as COL
from roibasedimagecompression_torch.utils import device as DEV


def _lab(image_rgb: np.ndarray, dev) -> torch.Tensor:
    return COL.rgb_to_lab_cv2(torch.from_numpy(np.array(image_rgb, np.uint8)).to(dev))


def clahe_custom_shadows(
    image_rgb: np.ndarray,
    shadow_mask: np.ndarray,
    clip_limit: float = 4.0,
    tile_size: int = 4,
    device=None,
) -> np.ndarray:
    """Apply CLAHE to the masked pixels only."""
    dev = DEV.resolve(device)
    lab = _lab(image_rgb, dev)
    mask = torch.from_numpy(np.asarray(shadow_mask, bool)).to(dev)
    if bool(mask.any()):
        lab = lab.clone()
        l_channel = lab[..., 0]
        l_channel[mask] = CL.clahe_1d(l_channel[mask], clip_limit=clip_limit, n_tiles=tile_size)
    return COL.lab_cv2_to_rgb(lab).cpu().numpy()


def enhance_shadows(
    image_rgb: np.ndarray,
    shadow_threshold: int = 100,
    clip_limit: float = 3.0,
    tile_size: int = 16,
    device=None,
) -> np.ndarray:
    """Shadow mask = scaled L < threshold; CLAHE over the shadow pixels."""
    dev = DEV.resolve(device)
    shadow_mask = (_lab(image_rgb, dev)[..., 0] < shadow_threshold).cpu().numpy()
    return clahe_custom_shadows(
        image_rgb, shadow_mask, clip_limit=clip_limit, tile_size=tile_size, device=dev
    )


#: Named CLAHE parameter presets of the parameter sweep.
CLAHE_PRESETS = (
    ("Conservative", {"clip_limit": 2.0, "tile_size": 8}),
    ("Balanced", {"clip_limit": 4.0, "tile_size": 8}),
    ("Aggressive", {"clip_limit": 8.0, "tile_size": 4}),
    ("Fine Detail", {"clip_limit": 6.0, "tile_size": 4}),
    ("Smooth", {"clip_limit": 3.0, "tile_size": 16}),
    ("Personal", {"clip_limit": 3.0, "tile_size": 16}),
)


def clahe_parameter_sweep(
    image_rgb: np.ndarray,
    shadow_mask: np.ndarray,
    combinations=CLAHE_PRESETS,
    figure_path=None,
    device=None,
) -> dict:
    """Run shadow CLAHE over a grid of (clip_limit, tile_size) presets.

    Returns {name: {'enhanced', 'brightening', 'params'}}: the enhanced
    image and the shadow pixels' L-channel brightening map.  With
    figure_path, also writes a 2-row comparison figure (matplotlib).
    """
    dev = DEV.resolve(device)
    mask = np.asarray(shadow_mask, bool)
    out = {}
    lab_orig = _lab(image_rgb, dev)[..., 0].cpu().numpy()
    for name, params in combinations:
        enhanced = clahe_custom_shadows(image_rgb, mask, device=dev, **params)
        lab_enh = _lab(enhanced, dev)[..., 0].cpu().numpy()
        diff = np.zeros_like(lab_orig, dtype=np.float32)
        diff[mask] = lab_enh[mask].astype(np.float32) - lab_orig[mask]
        out[name] = {"enhanced": enhanced, "brightening": diff, "params": dict(params)}

    if figure_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = len(out)
        fig, axes = plt.subplots(2, n, figsize=(3.3 * n, 7))
        for col, (name, r) in enumerate(out.items()):
            axes[0, col].imshow(r["enhanced"])
            axes[0, col].set_title(
                f"{name}\nclip {r['params']['clip_limit']}, "
                f"tile {r['params']['tile_size']}", fontsize=8,
            )
            im = axes[1, col].imshow(r["brightening"], cmap="RdYlBu", vmin=0, vmax=80)
            axes[1, col].set_title("brightening", fontsize=8)
            plt.colorbar(im, ax=axes[1, col], fraction=0.046, pad=0.04)
            for row in (0, 1):
                axes[row, col].axis("off")
        fig.tight_layout()
        fig.savefig(figure_path, dpi=100)
        plt.close(fig)
    return out


def clahe_full_image(image_rgb: np.ndarray, clip_limit: float = 3.0, grid: int = 8,
                     device=None) -> np.ndarray:
    """Whole-image L-channel CLAHE (the non-masked variant)."""
    dev = DEV.resolve(device)
    lab = _lab(image_rgb, dev).clone()
    lab[..., 0] = CL.clahe_2d(lab[..., 0].contiguous(), clip_limit=clip_limit, grid=grid)
    return COL.lab_cv2_to_rgb(lab).cpu().numpy()
