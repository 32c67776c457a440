"""VI optimizers: Adam over the {scalar, sbn} parameter groups.

Port of bito_tpu.vi.optimizers without optax.  The reference ships a
hand-rolled dict-of-arrays Adam (vip/sgd_server.py) driven by two
step-size policies (vip/optimizers.py: SimpleOptimizer decays every step;
BumpStepsizeOptimizer grows until the ELBO trace worsens, then restores
the best parameters and decays).  bito_tpu keeps its moments in optax's
ScaleByAdamState and does the math in host numpy; here the same math
runs on the same numpy arrays, and the state is the small AdamState
record below with the same fields (count, mu, nu), so the checkpoint
surface (adam_count, adam_mu, adam_nu, set_adam_state) is unchanged.

Conventions matched to the reference Adam (vip/sgd_server.py:32-46): ascent
(updates are added), bias-corrected moments, epsilon 1e-8 added outside the
square root.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AdamState:
    """Adam's moments over the two parameter groups, as optax's
    ScaleByAdamState holds them: the step count and {group: array}."""

    count: np.ndarray
    mu: dict
    nu: dict

_SCALAR = "scalar_params"
_SBN = "sbn_params"


class _AdamPolicyOptimizer:
    """Shared machinery: one Adam over the two parameter groups, with
    per-group step sizes applied outside it (they change every step under
    the policies below)."""

    # Policy constants (subclass overrides).
    decay_rate = 1.0 - 1e-2

    def __init__(self, sbn_model, scalar_model, elbo_estimator_fun):
        self.sbn_model = sbn_model
        self.scalar_model = scalar_model
        self.estimate_elbo = elbo_estimator_fun
        self.trace: list = []
        self.step_number = 0
        self.step_size = scalar_model.suggested_step_size()
        self.sbn_step_size = 0.001
        self._params_template = {
            _SCALAR: np.zeros(scalar_model.q_params.shape),
            _SBN: np.zeros(sbn_model.sbn_parameters.shape),
        }
        self.opt_state = AdamState(
            count=np.zeros([], dtype=np.int32),
            mu={k: np.zeros_like(v) for k, v in self._params_template.items()},
            nu={k: np.zeros_like(v) for k, v in self._params_template.items()})

    # -- checkpointing surface -------------------------------------------
    @property
    def adam_count(self) -> int:
        return int(self.opt_state.count)

    @property
    def adam_mu(self) -> dict:
        return {k: np.asarray(v) for k, v in self.opt_state.mu.items()}

    @property
    def adam_nu(self) -> dict:
        return {k: np.asarray(v) for k, v in self.opt_state.nu.items()}

    def set_adam_state(self, count: int, mu: dict, nu: dict):
        self.opt_state = AdamState(
            count=np.asarray(count, dtype=np.int32),
            mu={k: np.asarray(v) for k, v in mu.items()},
            nu={k: np.asarray(v) for k, v in nu.items()},
        )

    # -- stepping ----------------------------------------------------------
    def _apply_adam(self, grad_dict) -> bool:
        if not np.all(np.isfinite(grad_dict[_SCALAR])):
            return False
        assert grad_dict[_SCALAR].shape == self.scalar_model.q_params.shape
        assert grad_dict[_SBN].shape == self.sbn_model.sbn_parameters.shape
        grads = {_SCALAR: np.asarray(grad_dict[_SCALAR]),
                 _SBN: np.asarray(grad_dict[_SBN])}
        # Host numpy Adam, as the reference's (vip/sgd_server.py): moments,
        # bias correction, eps outside the sqrt.
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = int(self.opt_state.count) + 1
        mu = {k: np.asarray(v) for k, v in self.opt_state.mu.items()}
        nu = {k: np.asarray(v) for k, v in self.opt_state.nu.items()}
        direction = {}
        for k, g in grads.items():
            mu[k] = b1 * mu[k] + (1.0 - b1) * g
            nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
            mu_hat = mu[k] / (1.0 - b1 ** count)
            nu_hat = nu[k] / (1.0 - b2 ** count)
            direction[k] = mu_hat / (np.sqrt(nu_hat) + eps)
        self.opt_state = AdamState(
            count=np.asarray(count, dtype=np.int32), mu=mu, nu=nu)
        self.scalar_model.q_params += (
            self.step_size * direction[_SCALAR])
        self.sbn_model.sbn_parameters += (
            self.sbn_step_size * direction[_SBN])
        return True

    def gradient_step(self, grad_dict, history=None):
        ok = self._apply_adam(grad_dict)
        if ok and history is not None:
            history.append(self.scalar_model.q_params.copy())
            history.append(self.sbn_model.sbn_parameters.copy())
        self.update(ok)

    def update(self, gradient_step_was_successful):
        raise NotImplementedError


class SimpleOptimizer(_AdamPolicyOptimizer):
    """Decay the step size geometrically; halve it on a non-finite gradient
    (reference vip/optimizers.py SimpleOptimizer)."""

    def update(self, gradient_step_was_successful):
        self.step_size *= (self.decay_rate if gradient_step_was_successful
                           else 0.5)
        self.step_number += 1


class BumpStepsizeOptimizer(_AdamPolicyOptimizer):
    """Warm up the step size aggressively, then back off: grow 1.2x per step
    while a 5-step sliding window of ELBO estimates keeps improving; once it
    worsens (or a gradient goes non-finite), restore the best parameters
    seen, cut the step size by 4, and decay from there (reference
    vip/optimizers.py BumpStepsizeOptimizer)."""

    window = 5
    growth_rate = 1.2
    peak_drop = 4.0

    def __init__(self, sbn_model, scalar_model, elbo_estimator_fun):
        super().__init__(sbn_model, scalar_model, elbo_estimator_fun)
        self._warming_up = True
        self._best_elbo = -np.inf
        self._best_q_params = np.array(scalar_model.q_params, copy=True)

    def _back_off(self):
        np.copyto(self.scalar_model.q_params, self._best_q_params)
        self.step_size /= self.peak_drop
        self._warming_up = False

    def _window_worsened(self) -> bool:
        w = self.window
        if self.step_number < 2 * w:
            return False
        return np.mean(self.trace[-w:]) < np.mean(self.trace[-2 * w: -w])

    def update(self, gradient_step_was_successful):
        if not gradient_step_was_successful:
            self._back_off()
        if self._warming_up and self._window_worsened():
            self._back_off()
        self.step_size *= (self.growth_rate if self._warming_up
                           else self.decay_rate)
        elbo = self.estimate_elbo(particle_count=500)
        self.trace.append(elbo)
        if elbo > self._best_elbo:
            self._best_elbo = elbo
            np.copyto(self._best_q_params, self.scalar_model.q_params)
        self.step_number += 1
        return np.isfinite(elbo)


def of_name(name, sbn_model, scalar_model, elbo_estimator_fun):
    choices = {"simple": SimpleOptimizer, "bump": BumpStepsizeOptimizer}
    if name not in choices:
        raise ValueError(f"Optimizer {name} not known.")
    return choices[name](sbn_model, scalar_model, elbo_estimator_fun)
