"""Device and dtype policy of the port.

The product runs on one CUDA card in float32; the CPU in float64 is where
the tests hold the port against the JAX package.  Every constructor of the
port takes its device and dtype explicitly, and `resolve` checks the pair:
nothing here falls back to another device when the one asked for is
missing.
"""
from __future__ import annotations

import torch

PRODUCT_DEVICE = "cuda"
PRODUCT_DTYPE = torch.float32
TEST_DEVICE = "cpu"
TEST_DTYPE = torch.float64

FLOAT_DTYPES = (torch.float32, torch.float64)


def resolve(device, dtype) -> tuple[torch.device, torch.dtype]:
    """Validate an explicit (device, dtype) pair and return it normalised.

    Raises if the device is a CUDA device and no card is visible, or if the
    dtype is not float32 or float64."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}; use float32 or float64")
    return device, dtype
