"""Simplex (stick-breaking) transform, Stan convention (torch).

Port of bito_tpu.models.transforms (reference StickBreakingTransform,
src/stick_breaking_transform.cpp:20-57, following mc-stan.org/docs
simplex-transform).  The forward map is torch, so autodiff can
differentiate it: the rooted instance's substitution-model gradients come
from autodiff, where the reference takes central finite differences
(src/fat_beagle.cpp:422-508).  The inverse is numpy, as in
bito_tpu, since it only maps the current parameters to the unconstrained
space.
"""
from __future__ import annotations

import numpy as np
import torch


def stick_breaking_forward(y: torch.Tensor) -> torch.Tensor:
    """Unconstrained y (K-1) -> simplex x (K)."""
    K = y.shape[-1] + 1
    offsets = torch.log(torch.arange(K - 1, 0, -1, dtype=y.dtype,
                                     device=y.device))
    z = torch.sigmoid(y - offsets)
    # x_k = z_k * prod_{j<k} (1 - z_j)
    one_minus = torch.cat([torch.ones_like(z[..., :1]), 1.0 - z], dim=-1)
    stick = torch.cumprod(one_minus, dim=-1)
    return torch.cat([stick[..., :-1] * z, stick[..., -1:]], dim=-1)


def stick_breaking_inverse(x: np.ndarray) -> np.ndarray:
    """Simplex x (K) -> unconstrained y (K-1)."""
    x = np.asarray(x, dtype=np.float64)
    K = x.shape[-1]
    y = np.zeros(K - 1)
    total = 0.0
    for k in range(K - 1):
        z = x[k] / (1.0 - total)
        y[k] = np.log(z / (1.0 - z)) + np.log(K - k - 1)
        total += x[k]
    return y
