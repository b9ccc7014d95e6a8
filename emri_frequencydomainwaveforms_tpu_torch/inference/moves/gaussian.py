"""Metropolis-Hastings moves: Gaussian (isotropic, diagonal, full
covariance), adaptive Metropolis and differential evolution.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves
.gaussian``: `MHMove`, the generic symmetric-proposal MH step, and
`GaussianMove`, whose ``mode`` is "Gaussian" (a fixed covariance: scalar,
(ndim,) diagonal or (ndim, ndim) full, through its Cholesky factor), "AM"
(each temperature's empirical ensemble covariance + 1e-12 I, scaled by
2.38 / sqrt(ndim)) or "DE" (x + gamma (x_a - x_b) with two partners that
may be the walker itself, gamma = 2.38 / sqrt(2 ndim), and gamma = 1 for
10 % of the walkers).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .stretch import Move, _normal, _uniform, _wrap, mh_update


class MHMove(Move):
    """Generic symmetric-proposal MH over (ntemps, nwalkers, ndim).

    A subclass gives `proposal_draws` and `get_proposal`; the draws are
    (the proposal's draws, the accept uniforms (ntemps, nwalkers)), in that
    order.
    """

    def __init__(self, periodic=None):
        self.periodic = periodic

    def proposal_draws(self, generator, shape):
        raise NotImplementedError

    def get_proposal(self, coords, draws):
        """(proposal, log proposal ratio (ntemps, nwalkers)) on ``draws``."""
        raise NotImplementedError

    def draws(self, generator, shape):
        return self.proposal_draws(generator, shape), _uniform(generator, shape[:2])

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        prop, factors = self.get_proposal(coords, draws[0])
        return mh_update(coords, log_like, log_prior, betas, _wrap(prop, self.periodic), factors,
                         draws[1], logp_fn, logl_fn)


class GaussianMove(MHMove):
    """Gaussian random-walk MH.

    ``cov``: scalar (isotropic), (ndim,) diagonal or (ndim, ndim) full
    covariance; a dict of covariances per branch is kept as ``cov_dict``,
    for the multi-branch sampler to lift into a `TreeGaussianMove`. ``mode``:
    "Gaussian", "AM" or "DE" (module docstring). Proposal draws: "Gaussian"
    and "AM" one standard normal (ntemps, nwalkers, ndim); "DE" the two
    partner indices (ntemps, nwalkers) and the jump uniforms (ntemps,
    nwalkers, 1), in that order.
    """

    def __init__(self, cov, mode: str = "Gaussian", factor: float | None = None,
                 sky_periodic=None, periodic=None, indx_list=None, **kwargs):
        super().__init__(periodic=periodic)
        del kwargs, sky_periodic
        self.mode = mode
        self.factor = factor
        self.indx_list = indx_list
        self.cov_dict = cov if isinstance(cov, dict) else None
        self._chol = self._scale = self.ndim_cov = None
        if self.cov_dict is not None:
            return
        if np.isscalar(cov):
            self._scale = float(np.sqrt(cov))
            return
        cov = np.asarray(cov, dtype=np.float64)
        self._chol = torch.from_numpy(
            np.diag(np.sqrt(cov)) if cov.ndim == 1 else np.linalg.cholesky(cov))
        self.ndim_cov = cov.shape[0]

    def proposal_draws(self, generator, shape):
        ntemps, nwalkers = shape[:2]
        if self.mode == "DE":
            ia = torch.randint(0, nwalkers, (ntemps, nwalkers), generator=generator)
            ib = torch.randint(0, nwalkers, (ntemps, nwalkers), generator=generator)
            return ia, ib, _uniform(generator, (ntemps, nwalkers, 1))
        return (_normal(generator, shape),)

    def get_proposal(self, coords, draws):
        ntemps, nwalkers, ndim = coords.shape
        factors = torch.zeros((ntemps, nwalkers), dtype=coords.dtype)
        if self.mode == "DE":
            ia, ib, jump = draws
            xa = torch.gather(coords, 1, ia[..., None].expand(-1, -1, ndim))
            xb = torch.gather(coords, 1, ib[..., None].expand(-1, -1, ndim))
            g = torch.full_like(jump, 2.38 / math.sqrt(2.0 * ndim)).masked_fill(jump < 0.1, 1.0)
            return coords + g * (xa - xb), factors
        (z,) = draws
        if self.mode == "AM":
            xc = coords - torch.mean(coords, dim=1, keepdim=True)
            cov = torch.einsum("twi,twj->tij", xc, xc) / (nwalkers - 1)
            chol = torch.linalg.cholesky(cov + 1e-12 * torch.eye(ndim, dtype=coords.dtype))
            step = torch.einsum("tij,twj->twi", chol, z)
            return coords + (2.38 / math.sqrt(ndim)) * step, factors
        if self._chol is not None:
            return coords + z @ self._chol.T, factors
        if self._scale is None:
            raise NotImplementedError(
                "a GaussianMove with a covariance per branch runs in the multi-branch sampler "
                "(several branches, nleaves_max > 1 or rj_moves), which lifts it into a "
                "TreeGaussianMove")
        return coords + z * self._scale, factors


__all__ = ["MHMove", "GaussianMove"]
