"""Across-site rate-variation models: constant, Weibull+K, Gamma+K (torch).

Port of bito_tpu.models.site (reference: src/site_model.cpp:10-78).  The
shape parameter may carry leading batch axes ([...]); rates come back as
[..., K].  The Weibull model uses the reference's median discretisation;
Gamma+K is the median-discretised, mean-normalised Gamma (Yang 1994).
"""
from __future__ import annotations

import torch


def _median_quantiles(category_count: int, like: torch.Tensor) -> torch.Tensor:
    k = torch.arange(category_count, device=like.device, dtype=like.dtype)
    return (2.0 * k + 1.0) / (2.0 * category_count)


def weibull_category_rates(shape: torch.Tensor, category_count: int) -> torch.Tensor:
    """Median-discretised Weibull rates, normalised to mean 1
    (reference src/site_model.cpp:37-63)."""
    q = _median_quantiles(category_count, shape)
    rates = (-torch.log1p(-q)) ** (1.0 / shape[..., None])
    return rates / rates.mean(dim=-1, keepdim=True)


def gamma_median_category_rates(shape: torch.Tensor, category_count: int) -> torch.Tensor:
    """Median-discretised Gamma(shape, rate=shape) rates, mean-normalised."""
    a = shape[..., None]
    x = _gamma_quantile(_median_quantiles(category_count, shape), a)
    rates = x / a  # Gamma(shape=a, rate=a) has mean 1 before discretisation
    return rates / rates.mean(dim=-1, keepdim=True)


def _gamma_quantile(p: torch.Tensor, a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Inverse regularised lower incomplete gamma: Wilson-Hilferty start,
    then `iters` Newton steps on gammainc (as bito_tpu's, step for step)."""
    z = torch.special.ndtri(p)
    wh = a * (1.0 - 1.0 / (9.0 * a) + z / (3.0 * torch.sqrt(a))) ** 3
    x = torch.clamp_min(wh, 1e-8)
    lgamma_a = torch.lgamma(a)
    for _ in range(iters):
        f = torch.special.gammainc(a, x) - p
        logpdf = (a - 1.0) * torch.log(x) - x - lgamma_a  # Gamma(a, 1) pdf
        x_new = x - f / torch.exp(logpdf)
        x = torch.where(x_new > 0, x_new, x / 2.0)
    return x


class SiteModelSpec:
    """Factory matching reference SiteModel::OfSpecification
    (src/site_model.cpp:10-25); accepts "constant", "weibull[+K]", "gamma[+K]"."""

    def __init__(self, spec: str):
        self.spec = spec
        if spec == "constant":
            self.kind = "constant"
            self.category_count = 1
        elif spec.startswith("weibull") or spec.startswith("gamma"):
            self.kind = "weibull" if spec.startswith("weibull") else "gamma"
            self.category_count = int(spec.split("+")[1]) if "+" in spec else 4
        else:
            raise ValueError(f"Site model not known: {spec}")

    @property
    def param_counts(self):
        if self.kind == "constant":
            return {}
        return {"site_model_parameters": 1}

    def default_params(self, *, device, dtype):
        if self.kind == "constant":
            return {}
        return {"site_model_parameters": torch.ones(1, device=device, dtype=dtype)}

    def category_rates(self, params, *, device, dtype) -> torch.Tensor:
        if self.kind == "constant":
            return torch.ones(1, device=device, dtype=dtype)
        shape = params["site_model_parameters"][..., 0]
        if self.kind == "weibull":
            return weibull_category_rates(shape, self.category_count)
        return gamma_median_category_rates(shape, self.category_count)

    def category_proportions(self, params, *, device, dtype) -> torch.Tensor:
        return torch.full((self.category_count,), 1.0 / self.category_count,
                          device=device, dtype=dtype)
