"""PhyloFlags: runtime option flags for likelihood/gradient calls.

Host-side copy of bito_tpu.treelike.phylo_flags (no jax), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of the reference PhyloFlags system
(reference: src/phylo_flags.hpp:4-356, exported names
src/pybito.cpp:1269-1287).  Flags select which gradients are computed and
whether the height-transform log-det-Jacobian is included; they can be
passed per call (list of names, or (name, bool) pairs) or set sticky on the
instance.  SET_GRADIENT_DELTA is accepted for API compatibility but ignored:
gradients here are autodiff/closed-form, not finite differences.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

# Gradient flags (reference PhyloGradientFlagOptions, defaults in parens).
SITE_MODEL = "site_model"
CLOCK_MODEL = "clock_model"
RATIOS_ROOT_HEIGHT = "ratios_root_height"
SUBSTITUTION_MODEL = "substitution_model"
INCLUDE_LOG_DET_JACOBIAN_GRADIENT = "include_log_det_jacobian_gradient"
USE_STICKBREAKING_TRANSFORM = "use_stickbreaking_transform"
SET_GRADIENT_DELTA = "set_gradient_delta"
# Likelihood flags (reference LogLikelihoodFlagOptions).
INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD = "include_log_det_jacobian_likelihood"

# name -> (has_default, default_value)
_GRADIENT_DEFAULTS: Dict[str, Optional[bool]] = {
    SITE_MODEL: None,                  # no default: on only when requested
    CLOCK_MODEL: None,
    RATIOS_ROOT_HEIGHT: None,
    SUBSTITUTION_MODEL: None,
    INCLUDE_LOG_DET_JACOBIAN_GRADIENT: True,
    USE_STICKBREAKING_TRANSFORM: True,
    INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD: True,
}

ALL_FLAG_NAMES = tuple(_GRADIENT_DEFAULTS.keys()) + (SET_GRADIENT_DELTA,)

FlagsInput = Union[
    None,
    "PhyloFlags",
    Iterable[Union[str, Tuple[str, bool], Tuple[str, bool, float]]],
]


class PhyloFlags:
    """A set of explicitly-set flags plus a use-defaults policy (reference
    PhyloFlags: per-flag defaults apply unless use_defaults is False, in
    which case only explicitly-set flags are active)."""

    def __init__(self, flags: FlagsInput = None, use_defaults: bool = True):
        self.use_defaults = use_defaults
        self.explicit: Dict[str, bool] = {}
        self.values: Dict[str, float] = {}
        if isinstance(flags, PhyloFlags):
            self.use_defaults = flags.use_defaults if use_defaults else False
            self.explicit = dict(flags.explicit)
            self.values = dict(flags.values)
        elif flags is not None:
            for entry in flags:
                if isinstance(entry, str):
                    self.set(entry, True)
                elif len(entry) == 2:
                    self.set(entry[0], bool(entry[1]))
                else:
                    self.set(entry[0], bool(entry[1]), float(entry[2]))

    def set(self, name: str, value: bool = True,
            set_value: Optional[float] = None):
        if name not in ALL_FLAG_NAMES:
            raise ValueError(f"Unknown phylo flag: {name!r}")
        self.explicit[name] = value
        if set_value is not None:
            self.values[name] = set_value

    def clear(self):
        self.explicit.clear()
        self.values.clear()

    def is_set(self, name: str) -> bool:
        """Is the flag active? Explicit setting wins; otherwise the default
        applies when use_defaults is on.  Flags without defaults (the
        gradient-selection flags) additionally turn ALL of their group on
        when none of the group was requested explicitly (the reference's
        behavior: a bare phylo_gradients() computes every available
        gradient)."""
        if name in self.explicit:
            return self.explicit[name]
        if not self.use_defaults:
            return False
        default = _GRADIENT_DEFAULTS.get(name)
        if default is not None:
            return default
        # Gradient-selection flag with no default: active iff no selection
        # flag was explicitly requested (all-on), else inactive.
        selection = (SITE_MODEL, CLOCK_MODEL, RATIOS_ROOT_HEIGHT,
                     SUBSTITUTION_MODEL)
        any_selected = any(
            self.explicit.get(s, False) for s in selection
        )
        return not any_selected

    def value_of(self, name: str, default: float) -> float:
        return self.values.get(name, default)


def resolve(flags: FlagsInput, sticky: Optional[PhyloFlags],
            use_defaults: bool = True) -> PhyloFlags:
    """Per-call flags win over sticky instance flags (reference
    PhyloFlags::IsFlagSet resolution)."""
    if flags is not None:
        return PhyloFlags(flags, use_defaults)
    if sticky is not None:
        return sticky
    return PhyloFlags(None, use_defaults)
