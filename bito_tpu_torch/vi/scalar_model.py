"""Scalar variational models (reference: vip/scalar_model.py:1-308).

Port of bito_tpu.vi.scalar_model.  LogNormalModel is bito_tpu's numpy
code as it is: the reference's hand-derived reparameterization gradients
(eq:gLogNorm, eq:dgdPsi, eq:dlogqgdPsi), vectorized over particles.  The
reference's TFScalarModel (TensorFlow-probability autodiff), bito_tpu's
JAXScalarModel, becomes TorchScalarModel: the same three distributions
(gamma, lognormal, truncated lognormal) with torch.func.jacfwd supplying
dg/dpsi and dlog q(g)/dpsi, in float64 on the host (a few hundred
scalars; no device work).  The base draws come from the model's numpy
rng, draw for draw as in bito_tpu, so both sample the same values.
"""
from __future__ import annotations

import abc
from typing import List, Optional

import math

import numpy as np
import torch


class ScalarModel(abc.ABC):
    def __init__(self, initial_params: np.ndarray, variable_count: int):
        assert initial_params.ndim == 1
        self.q_params = np.full((variable_count, len(initial_params)),
                                initial_params, dtype=np.float64)
        self.rng = np.random.default_rng()

    @property
    def variable_count(self):
        return self.q_params.shape[0]

    @property
    def param_count(self):
        return self.q_params.shape[1]

    def suggested_step_size(self):
        return np.average(np.abs(self.q_params), axis=0) / 100

    @abc.abstractmethod
    def mode_match(self, modes):
        ...

    @abc.abstractmethod
    def sample(self, px_which_variables):
        ...

    @abc.abstractmethod
    def sample_and_gradients(self, px_which_variables, prebaked_sample=None):
        ...

    @abc.abstractmethod
    def log_prob(self, values, which_variables):
        ...


class LogNormalModel(ScalarModel):
    """Log-normal with hand-computed gradients
    (reference vip/scalar_model.py LogNormalModel)."""

    def __init__(self, initial_params, variable_count):
        super().__init__(initial_params, variable_count)
        self.name = "LogNormal"

    def mu(self, which_variables=None):
        if which_variables is None:
            return self.q_params[:, 0]
        return self.q_params[which_variables, 0]

    def sigma(self, which_variables=None):
        if which_variables is None:
            return self.q_params[:, 1]
        return self.q_params[which_variables, 1]

    def mode_match(self, modes):
        log_modes = np.log(np.clip(modes, 1e-6, None))
        biclipped = np.log(np.clip(modes, 1e-6, 1 - 1e-6))
        self.q_params[:, 1] = -0.1 * biclipped
        self.q_params[:, 0] = np.square(self.sigma()) + log_modes

    def sample_all(self, particle_count):
        return self.rng.lognormal(
            self.mu(), self.sigma(), (particle_count, self.variable_count)
        )

    def sample(self, px_which_variables):
        particle_count = len(px_which_variables)
        size = px_which_variables[0].size
        sample = np.empty((particle_count, size))
        for i, wv in enumerate(px_which_variables):
            assert wv.size == size
            sample[i, :] = self.rng.lognormal(self.mu(wv), self.sigma(wv))
        return sample

    def sample_and_gradients(self, px_which_variables, prebaked_sample=None):
        particle_count = len(px_which_variables)
        size = px_which_variables[0].size
        sample = np.empty((particle_count, size))
        dg_dpsi = np.zeros((particle_count, self.variable_count, 2))
        dlog_qg_dpsi = np.zeros((particle_count, self.variable_count, 2))
        dlog_qg_dpsi[:, :, 0] = -1.0  # eq:dlogqgdPsi
        for i, wv in enumerate(px_which_variables):
            mu, sigma = self.mu(wv), self.sigma(wv)
            if prebaked_sample is None:
                sample[i, :] = self.rng.lognormal(mu, sigma)
            else:
                sample[:, :] = prebaked_sample
            epsilon = (np.log(sample[i, :]) - mu) / sigma  # eq:gLogNorm
            dg_dpsi[i, wv, 0] = sample[i, :]               # eq:dgdPsi
            dg_dpsi[i, wv, 1] = sample[i, :] * epsilon
            dlog_qg_dpsi[i, wv, 1] = -epsilon - 1.0 / sigma
        return sample, dg_dpsi, dlog_qg_dpsi

    @staticmethod
    def general_log_prob(values, mu, sigma):
        log_values = np.log(values)
        ratio = (log_values - mu) ** 2 / (2 * sigma ** 2)
        return -(
            np.sum(log_values)
            + np.sum(np.log(sigma))
            + values.size * 0.5 * np.log(2 * np.pi)
            + np.sum(ratio)
        )

    def log_prob(self, values, which_variables):
        assert values.size == which_variables.size
        return LogNormalModel.general_log_prob(
            values, self.mu(which_variables), self.sigma(which_variables)
        )


class TorchScalarModel(ScalarModel):
    """Autodiff scalar model over a named distribution: the port's analog
    of the reference's TFScalarModel (vip/scalar_model.py:188-270) and
    bito_tpu's JAXScalarModel.

    Distributions are parameterized as in the reference factories:
      gamma:              concentration=exp(p0), rate=exp(p1)
      lognormal:          loc=p0, scale=p1
      truncated_lognormal loc=p0, scale=p1, upper=exp(p2) (soft truncation)
    Sampling is reparameterized; gradients of (g, log q(g)) wrt psi come from
    torch.func.jacfwd instead of hand derivations.
    """

    DISTRIBUTIONS = ("gamma", "lognormal", "truncated_lognormal")

    def __init__(self, name: str, initial_params, variable_count):
        if name not in self.DISTRIBUTIONS:
            raise ValueError(f"Unknown scalar distribution {name}")
        super().__init__(np.asarray(initial_params, dtype=np.float64),
                         variable_count)
        self.name = name

    # g(psi, eps): reparameterized sample from base normal/uniform draw
    def _g(self, params, eps):
        if self.name == "lognormal":
            return torch.exp(params[..., 0] + params[..., 1] * eps)
        if self.name == "gamma":
            # Approximate reparameterization via lognormal moment matching of
            # Gamma(exp(p0), exp(p1)) (sufficient for VI fitting).
            conc = torch.exp(params[..., 0])
            rate = torch.exp(params[..., 1])
            mu = torch.log(conc / rate) - 0.5 * torch.log1p(1.0 / conc)
            sigma = torch.sqrt(torch.log1p(1.0 / conc))
            return torch.exp(mu + sigma * eps)
        # truncated lognormal: squash the base lognormal below exp(p2)
        upper = torch.exp(params[..., 2])
        raw = torch.exp(params[..., 0] + params[..., 1] * eps)
        return upper * raw / (upper + raw)

    def _log_q(self, params, value):
        if self.name == "lognormal":
            mu, sigma = params[..., 0], params[..., 1]
            return (_norm_logpdf(torch.log(value), mu, sigma)
                    - torch.log(value))
        if self.name == "gamma":
            conc = torch.exp(params[..., 0])
            rate = torch.exp(params[..., 1])
            return _gamma_logpdf(value, conc, 1.0 / rate)
        upper = torch.exp(params[..., 2])
        mu, sigma = params[..., 0], params[..., 1]
        room = torch.clamp(upper - value, min=1e-10)
        raw = value * upper / room
        base = _norm_logpdf(torch.log(raw), mu, sigma) - torch.log(raw)
        jac = (upper / room) ** 2
        return base + torch.log(jac)

    def mode_match(self, modes):
        log_modes = np.log(np.clip(modes, 1e-6, None))
        if self.name == "lognormal":
            self.q_params[:, 1] = 0.1
            self.q_params[:, 0] = log_modes + 0.01
        elif self.name == "gamma":
            self.q_params[:, 0] = 1.0
            self.q_params[:, 1] = -log_modes
        else:
            self.q_params[:, 1] = 0.1
            self.q_params[:, 0] = log_modes + 0.01

    def sample(self, px_which_variables):
        particle_count = len(px_which_variables)
        size = px_which_variables[0].size
        eps = self.rng.standard_normal((particle_count, size))
        out = np.empty((particle_count, size))
        for i, wv in enumerate(px_which_variables):
            out[i] = self._g(_f64(self.q_params[wv]), _f64(eps[i])).numpy()
        return out

    def sample_all(self, particle_count):
        wv = np.arange(self.variable_count)
        return self.sample([wv] * particle_count)

    def sample_and_gradients(self, px_which_variables, prebaked_sample=None):
        from torch.func import jacfwd, vmap

        particle_count = len(px_which_variables)
        size = px_which_variables[0].size
        sample = np.empty((particle_count, size))
        dg_dpsi = np.zeros((particle_count, self.variable_count,
                            self.param_count))
        dlog_qg_dpsi = np.zeros_like(dg_dpsi)

        def g_scalar(p, e):
            return self._g(p[None, :], e)[0]

        def logq_of_psi(p, e):
            return self._log_q(p[None, :], g_scalar(p, e))[0]

        g_jac = vmap(jacfwd(g_scalar), in_dims=(0, 0))
        q_jac = vmap(jacfwd(logq_of_psi), in_dims=(0, 0))
        g_vec = vmap(g_scalar, in_dims=(0, 0))
        for i, wv in enumerate(px_which_variables):
            if prebaked_sample is not None:
                if self.name != "lognormal":
                    raise ValueError(
                        "prebaked_sample only supported for lognormal"
                    )
                mu = self.q_params[wv, 0]
                sigma = self.q_params[wv, 1]
                eps = _f64((np.log(prebaked_sample[i]) - mu) / sigma)
            else:
                eps = _f64(self.rng.standard_normal(size))
            p = _f64(self.q_params[wv])
            sample[i] = g_vec(p, eps).numpy()
            dg_dpsi[i, wv, :] = g_jac(p, eps).numpy()
            dlog_qg_dpsi[i, wv, :] = q_jac(p, eps).numpy()
        return sample, dg_dpsi, dlog_qg_dpsi

    def log_prob(self, values, which_variables):
        p = _f64(self.q_params[which_variables])
        return float(self._log_q(p, _f64(values)).sum())


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


_LOG_2PI = math.log(2 * math.pi)


def _norm_logpdf(x, loc, scale):
    """log N(x; loc, scale), as jax.scipy.stats.norm.logpdf writes it."""
    return -0.5 * (_LOG_2PI + 2 * torch.log(scale)
                   + (x - loc) ** 2 / scale ** 2)


def _gamma_logpdf(x, a, scale):
    """log Gamma(x; shape a, scale) for x > 0, as
    jax.scipy.stats.gamma.logpdf writes it."""
    y = x / scale
    return torch.xlogy(a - 1.0, y) - y - (torch.lgamma(a) + torch.log(scale))


def of_name(scalar_model_name: str, variable_count: int) -> ScalarModel:
    """Reference vip/scalar_model.py factories (of_name)."""
    if scalar_model_name == "lognormal":
        return LogNormalModel(np.array([-2.0, 0.5]), variable_count)
    if scalar_model_name in ("tf_lognormal", "jax_lognormal"):
        return TorchScalarModel("lognormal", np.array([-2.0, 0.5]),
                                variable_count)
    if scalar_model_name in ("tf_gamma", "jax_gamma"):
        return TorchScalarModel("gamma", np.array([1.0, 3.0]), variable_count)
    if scalar_model_name in ("tf_truncated_lognormal",
                             "jax_truncated_lognormal"):
        return TorchScalarModel("truncated_lognormal",
                                np.array([-2.0, 0.5, 0.1]), variable_count)
    raise ValueError(f"ScalarModel {scalar_model_name} not known.")
