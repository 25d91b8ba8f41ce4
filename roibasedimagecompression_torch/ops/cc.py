"""Connected components of a boolean mask on the host runtime.

The counterpart of the native branch of the JAX package's
`ops/cc.py connected_components`.  Its device propagation fallback, for a
host without the runtime, is not ported (ROADMAP A13): without the runtime
this raises.
"""

from __future__ import annotations

import numpy as np

from roibasedimagecompression_torch import native


def connected_components(mask: np.ndarray, connectivity: int = 8):
    """cv2.connectedComponents analogue: (labels (h, w) int32 with 0 the
    background and 1..n compact ids in raster order, n + 1)."""
    mask = np.asarray(mask) != 0
    if not mask.any():
        return np.zeros(mask.shape, np.int32), 1
    try:
        labels, n, _ = native.cc_label(mask, connectivity)
    except (OSError, RuntimeError) as exc:
        raise NotImplementedError(
            "connected components without the native runtime (the device "
            "propagation fallback) are not ported yet: ROADMAP A13"
        ) from exc
    return labels, n + 1
