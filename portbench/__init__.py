"""The benchmark of `roibasedimagecompression_torch` on one H100 (`run.py`)."""
