"""Independence MH move drawing from a fixed distribution.

Counterpart of the single-branch contract of
``emri_frequencydomainwaveforms_tpu.inference.moves.distgen
.DistributionGenerate``: every walker proposes brand-new coordinates from a
distribution q (a `ProbDistContainer`, unit-cube draws through each
parameter's ``ppf``), with ``log q(old) - log q(new)`` in the MH ratio. A
mode-hopping move to mix with local ones in a schedule.
"""

from __future__ import annotations

import torch

from .stretch import Move, _uniform, mh_update


def ppf_draw(dist, u: torch.Tensor) -> torch.Tensor:
    """Unit-cube points ``u`` (..., ndim) through the container's ppf of
    each parameter index."""
    return torch.stack([dist.priors_in[i].ppf(u[..., i]) for i in range(u.shape[-1])], dim=-1)


class DistributionGenerate(Move):
    """Independence sampler from ``generate_dist`` (a `ProbDistContainer`,
    or a dict of one per branch, of which the single-branch sampler uses the
    first). Draws: the unit-cube points (ntemps, nwalkers, ndim), then the
    accept uniforms (ntemps, nwalkers)."""

    def __init__(self, generate_dist, periodic=None, **kwargs):
        del kwargs
        self.dist = generate_dist
        self.periodic = periodic  # unused: the draws are already in the support

    def _flat_dist(self):
        return next(iter(self.dist.values())) if isinstance(self.dist, dict) else self.dist

    def propose(self, generator, coords, *args):
        if isinstance(coords, dict):
            return self.propose_tree(generator, coords, *args)
        return super().propose(generator, coords, *args)

    def propose_tree(self, *args):
        raise NotImplementedError(
            "DistributionGenerate.propose_tree (the multi-branch contract) is not ported "
            "(ROADMAP Queue 1 item 7): use the JAX package's inference.moves.distgen")

    def draws(self, generator, shape):
        return _uniform(generator, shape), _uniform(generator, shape[:2])

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        dist = self._flat_dist()
        u_draw, u = draws
        q = ppf_draw(dist, u_draw)
        factors = dist.logpdf(coords) - dist.logpdf(q)
        return mh_update(coords, log_like, log_prior, betas, q, factors, u, logp_fn, logl_fn)


__all__ = ["DistributionGenerate", "ppf_draw"]
