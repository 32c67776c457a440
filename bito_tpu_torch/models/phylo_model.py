"""PhyloModel: substitution + site + clock models with a block-specified
flat parameter vector (torch).

Port of bito_tpu.models.phylo_model (reference: src/phylo_model.hpp:13-63,
src/block_specification.hpp:17-74).  The block map and its keys are the
same as bito_tpu's, so a parameter dict carries over unchanged
(convert.params_from_numpy).  The device-side ingredients take an explicit
device and dtype, since a model without parameters (JC69, constant sites,
no clock) has no tensor to take them from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .clock import ClockModelSpec
from .site import SiteModelSpec
from .substitution import EigenDecomp, SubstitutionModelSpec


@dataclass(frozen=True)
class PhyloModelSpecification:
    """Mirror of bito.PhyloModelSpecification (src/phylo_model.hpp:13-17)."""

    substitution: str = "JC69"
    site: str = "constant"
    clock: str = "none"


class PhyloModel:
    def __init__(self, spec: PhyloModelSpecification):
        self.spec = spec
        self.substitution = SubstitutionModelSpec(spec.substitution)
        self.site = SiteModelSpec(spec.site)
        self.clock = ClockModelSpec(spec.clock)
        # (start, length) per key, in substitution, site, clock order
        # (reference PhyloModel ctor).
        blocks: Dict[str, Tuple[int, int]] = {}
        offset = 0
        for sub in (self.substitution, self.site, self.clock):
            for key, count in sub.param_counts.items():
                blocks[key] = (offset, count)
                offset += count
        self.blocks = blocks
        self.param_count = offset

    def default_param_vector(self) -> np.ndarray:
        v = np.zeros(self.param_count)
        for sub in (self.substitution, self.site, self.clock):
            defaults = sub.default_params(device="cpu", dtype=torch.float64)
            for key, val in defaults.items():
                start, length = self.blocks[key]
                v[start:start + length] = val.numpy()
        return v

    # Device-side model ingredients -------------------------------------
    def eigen(self, params, *, device, dtype) -> EigenDecomp:
        return self.substitution.eigen(params, device=device, dtype=dtype)

    def category_rates(self, params, *, device, dtype) -> torch.Tensor:
        return self.site.category_rates(params, device=device, dtype=dtype)

    def category_proportions(self, params, *, device, dtype) -> torch.Tensor:
        return self.site.category_proportions(params, device=device, dtype=dtype)

    def clock_rate(self, params, *, device, dtype) -> torch.Tensor:
        return self.clock.rate(params, device=device, dtype=dtype)

    def rate_matrix(self, params, *, device, dtype):
        """Padded Q for uniformized transition matrices (codon models);
        None for models served by the eigen route."""
        return self.substitution.rate_matrix(params, device=device,
                                             dtype=dtype)

    @property
    def category_count(self) -> int:
        return self.site.category_count

    @property
    def num_states(self) -> int:
        """Per-state dimension A (4 for nucleotide models, 64 for the
        padded codon models); flows into every engine buffer shape."""
        return self.substitution.num_states
