"""Clock models: none, strict (torch).

Port of bito_tpu.models.clock (reference: src/clock_model.hpp:23-46).
"none" fixes the rate at 1 (unrooted/classical likelihoods); "strict"
applies one global rate to all branches of a rooted time tree.
"""
from __future__ import annotations

import torch


class ClockModelSpec:
    def __init__(self, spec: str):
        if spec not in ("none", "strict"):
            raise ValueError(f"Clock model not known: {spec}")
        self.spec = spec

    @property
    def param_counts(self):
        if self.spec == "none":
            return {}
        return {"clock_model_rates": 1}

    def default_params(self, *, device, dtype):
        if self.spec == "none":
            return {}
        return {"clock_model_rates": torch.ones(1, device=device, dtype=dtype)}

    def rate(self, params, *, device, dtype) -> torch.Tensor:
        if self.spec == "none":
            return torch.ones((), device=device, dtype=dtype)
        return params["clock_model_rates"][..., 0]
