"""Host-side image file IO (PNG/JPEG).  PIL is imported inside the functions:
the codec itself does not need it."""

from __future__ import annotations

import numpy as np


def imread_rgb(path) -> np.ndarray:
    """Read an image file as (h, w, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def imwrite(path, image: np.ndarray, **kwargs) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image, dtype=np.uint8)).save(path, **kwargs)
