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


def jpeg_bytes(image: np.ndarray, quality: int = 85) -> bytes:
    """Encode an RGB image to JPEG bytes at the given quality (the JPEG
    baseline of the evaluation)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image, dtype=np.uint8)).save(buf, format="JPEG", quality=int(quality))
    return buf.getvalue()


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8 RGB."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
