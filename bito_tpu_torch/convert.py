"""Carry state from bito_tpu to the port.

bito_tpu's engines take a parameter dict keyed by the model's block names
(models/phylo_model.py), with values that are shared rows [k] or per-tree
rows [B, k].  The port uses the same keys; this turns the numpy form of
such a dict into the port's tensors, so both packages compute from the
same numbers.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import resolve


def params_from_numpy(params: Mapping[str, np.ndarray], device,
                      dtype) -> Dict[str, torch.Tensor]:
    """{block name: array} -> {block name: tensor on (device, dtype)}."""
    device, dtype = resolve(device, dtype)
    return {key: torch.as_tensor(np.asarray(value), dtype=dtype, device=device)
            for key, value in params.items()}
