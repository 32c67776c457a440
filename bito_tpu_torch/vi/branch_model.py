"""Branch-length variational models: SplitModel and PSPModel
(reference: vip/branch_model.py:60-300).

Branch lengths are modeled by lognormals whose parameters are indexed by
splits (SplitModel) or summed over PSP triples (PSPModel, with the
first_empty_index sentinel row pinned to zero).

Copy of bito_tpu.vi.branch_model, pinned equal to it by
tests/test_torch_sbn.py; its scalar_model import is the port's module.
"""
from __future__ import annotations

import numpy as np

from . import priors, scalar_model
from .scalar_model import LogNormalModel


class BranchModel:
    def __init__(self, scalar_model_name, inst):
        self.inst = inst
        self.make_raw_representation = inst.make_psp_indexer_representations
        self.scalar_model = scalar_model.of_name(
            scalar_model_name, variable_count=self._compute_variable_count(inst)
        )
        self.log_prior = priors.log_exp_prior
        self.grad_log_prior = priors.grad_log_exp_prior

    def _dlogp_dtheta(self, theta_sample, phylo_gradients):
        """Gradient of the log unnormalized posterior wrt branch lengths.

        The reference trims two trailing zeros from bito's detrifurcated
        gradient (vip/branch_model.py:118-122); our engine's gradient is
        per-node with the root entry unused, so we trim one."""
        out = np.zeros_like(theta_sample)
        for i, pg in enumerate(phylo_gradients):
            out[i, :] = pg.gradient_["branch_lengths"][:-1]
        out += self.grad_log_prior(theta_sample)
        return out


class SplitModel(BranchModel):
    """One lognormal per split (reference vip/branch_model.py:60-134)."""

    @staticmethod
    def _compute_variable_count(inst):
        return inst.psp_indexer.details()["after_rootsplits_index"]

    def px_branch_representation(self):
        return [
            np.array(representation[0])
            for representation in self.make_raw_representation()
        ]

    def mode_match(self, split_modes):
        self.scalar_model.mode_match(split_modes)

    def sample(self, px_branch_representation):
        return self.scalar_model.sample(px_branch_representation)

    def sample_all(self, particle_count):
        return self.scalar_model.sample_all(particle_count)

    def log_prob_generator(self, px_theta_sample, px_branch_representation):
        for i, branch_to_split in enumerate(px_branch_representation):
            yield self.scalar_model.log_prob(
                px_theta_sample[i, :], which_variables=branch_to_split
            )

    def log_prob(self, px_theta_sample, px_branch_representation):
        return sum(self.log_prob_generator(px_theta_sample,
                                           px_branch_representation))

    def sample_and_gradients(self, px_branch_representation):
        return self.scalar_model.sample_and_gradients(px_branch_representation)

    def scalar_grad(self, theta_sample, phylo_gradients, px_branch_to_split,
                    dg_dpsi, dlog_qg_dpsi):
        """eq:dLdPsi accumulation (reference vip/branch_model.py:103-134)."""
        dlogp_dtheta = self._dlogp_dtheta(theta_sample, phylo_gradients)
        grad = np.zeros(
            (self.scalar_model.variable_count, self.scalar_model.param_count)
        )
        for i, branch_to_split in enumerate(px_branch_to_split):
            np.add.at(
                grad, branch_to_split,
                dlogp_dtheta[i, :, None] * dg_dpsi[i, branch_to_split, :]
                - dlog_qg_dpsi[i, branch_to_split, :],
            )
        return grad


class PSPModel(BranchModel):
    """Lognormal parameters summed over the (rootsplit, down, up) PSP triple
    (reference vip/branch_model.py:136-300)."""

    def __init__(self, scalar_model_name, inst):
        if scalar_model_name != "lognormal":
            raise ValueError("PSP only works with LogNormal.")
        super().__init__(scalar_model_name, inst)
        details = inst.psp_indexer.details()
        assert details["rootsplit_position"] == 0
        assert details["subsplit_down_position"] == 1
        assert details["subsplit_up_position"] == 2
        self.after_rootsplits_index = details["after_rootsplits_index"]
        self.q_params = self.scalar_model.q_params
        self.q_params[-1, :] = 0.0  # sentinel row stays zero

    @staticmethod
    def _compute_variable_count(inst):
        return inst.psp_indexer.details()["first_empty_index"] + 1

    def px_branch_representation(self):
        return [np.array(r) for r in self.make_raw_representation()]

    def mode_match(self, split_modes):
        assert split_modes.size == self.after_rootsplits_index
        self.q_params[:, :] = 0.0
        log_modes = np.log(np.clip(split_modes, 1e-6, None))
        biclipped = np.log(np.clip(split_modes, 1e-6, 1 - 1e-6))
        split_q = self.q_params[: self.after_rootsplits_index, :]
        split_q[:, 1] = -0.1 * biclipped
        split_q[:, 0] = np.square(split_q[:, 1]) + log_modes

    def _make_lognormal_params(self, branch_representation):
        return self.q_params[branch_representation, :].sum(axis=0)

    def sample(self, px_branch_representation):
        assert len(px_branch_representation) > 0
        shape = px_branch_representation[0].shape
        out = np.empty((len(px_branch_representation), shape[1]))
        for i, br in enumerate(px_branch_representation):
            assert br.shape == shape
            params = self._make_lognormal_params(br)
            out[i, :] = self.scalar_model.rng.lognormal(params[:, 0],
                                                        params[:, 1])
        return out

    def sample_all(self, particle_count):
        return np.zeros((self.after_rootsplits_index, 1))

    def log_prob_generator(self, px_theta_sample, px_branch_representation):
        for i, br in enumerate(px_branch_representation):
            params = self._make_lognormal_params(br)
            yield LogNormalModel.general_log_prob(
                px_theta_sample[i, :], params[:, 0], params[:, 1]
            )

    def log_prob(self, theta_sample, px_branch_representation):
        return sum(self.log_prob_generator(theta_sample,
                                           px_branch_representation))

    def sample_and_gradients(self, px_branch_representation):
        particle_count = len(px_branch_representation)
        shape = px_branch_representation[0].shape
        sample = np.empty((particle_count, shape[1]))
        dg_dpsi = np.zeros((particle_count, self.scalar_model.variable_count, 2))
        dlog_qg_dpsi = np.zeros_like(dg_dpsi)
        dlog_qg_dpsi[:, :, 0] = -1.0  # eq:dlogqgdPsi
        for i, br in enumerate(px_branch_representation):
            assert br.shape == shape
            params = self._make_lognormal_params(br)
            mu, sigma = params[:, 0], params[:, 1]
            sample[i, :] = self.scalar_model.rng.lognormal(mu, sigma)
            epsilon = (np.log(sample[i, :]) - mu) / sigma  # eq:gLogNorm
            for which_variables in br:
                dg_dpsi[i, which_variables, 0] = sample[i, :]  # eq:dgdPsi
                dg_dpsi[i, which_variables, 1] = sample[i, :] * epsilon
                dlog_qg_dpsi[i, which_variables, 1] = -epsilon - 1.0 / sigma
        return sample, dg_dpsi, dlog_qg_dpsi

    def scalar_grad(self, theta_sample, phylo_gradients,
                    px_branch_representation, dg_dpsi, dlog_qg_dpsi):
        dlogp_dtheta = self._dlogp_dtheta(theta_sample, phylo_gradients)
        grad = np.zeros(
            (self.scalar_model.variable_count, self.scalar_model.param_count)
        )
        for i, br in enumerate(px_branch_representation):
            for which_variables in br:
                np.add.at(
                    grad, which_variables,
                    dlogp_dtheta[i, :, None] * dg_dpsi[i, which_variables, :]
                    - dlog_qg_dpsi[i, which_variables, :],
                )
        grad[-1, :] = 0.0  # sentinel stays zero
        return grad


def of_name(branch_model_name, scalar_model_name, inst):
    choices = {"split": SplitModel, "psp": PSPModel}
    if branch_model_name not in choices:
        raise ValueError(f"BranchModel {branch_model_name} not known.")
    return choices[branch_model_name](scalar_model_name, inst)
