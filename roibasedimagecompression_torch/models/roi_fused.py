"""ROI / non-ROI masks from the host runtime's mask pipeline."""

from __future__ import annotations

import numpy as np

from roibasedimagecompression_torch import config as cfg
from roibasedimagecompression_torch import native


def roi_masks_fast(image_rgb: np.ndarray, config: cfg.CodecConfig, low, high):
    """(roi_mask, nonroi_mask) bool arrays for Canny thresholds (low, high)."""
    return native.roi_pipeline(image_rgb, float(low), float(high), config.roi)
