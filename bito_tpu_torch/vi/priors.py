"""Branch-length priors (reference: vip/priors.py:1-20).

Copy of bito_tpu.vi.priors, pinned equal to it by tests/test_torch_sbn.py.
"""
import numpy as np


def log_exp_prior(px_theta_sample, rate=10):
    """Log Exponential(rate) density, summed over branches per particle."""
    assert px_theta_sample.ndim == 2
    return np.log(rate) * px_theta_sample.shape[1] - rate * np.sum(
        px_theta_sample, axis=1
    )


def grad_log_exp_prior(px_theta_sample, rate=10):
    return -rate
