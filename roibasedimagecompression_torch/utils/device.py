"""Device choice for the port's entry points.

`device=None` means CUDA.  Without a card the entry points raise: they never
slide to the CPU.  Callers (the tests) ask for the CPU with device="cpu".
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device for an entry point, with TF32 off everywhere.

    The JAX package pins Precision.HIGHEST on every matmul and convolution;
    cuDNN's default TF32 would round every float32 convolution to 10 bits of
    mantissa, so both TF32 switches are turned off here.
    """
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def or_cpu(device) -> torch.device:
    """The device of a library function's own work: the caller's, or the
    CPU when None (the entry points resolve theirs above)."""
    return torch.device("cpu" if device is None else device)
