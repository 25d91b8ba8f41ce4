"""RHCCQ image codec on PyTorch and CUDA.

ROI-based hierarchical clustering color quantization: the port of this
repository's JAX package to one NVIDIA H100.  It writes the same `.rhccq`
stream.

    import roibasedimagecompression_torch as rtt
    data = rtt.encode(image)            # on CUDA; device="cpu" for the CPU
    image2 = rtt.decode(data)
"""

from roibasedimagecompression_torch.config import CodecConfig, RoiConfig, from_dict
from roibasedimagecompression_torch.io.container import unpack
from roibasedimagecompression_torch.models.codec import decode, encode

__all__ = ["CodecConfig", "RoiConfig", "from_dict", "encode", "decode", "unpack"]
