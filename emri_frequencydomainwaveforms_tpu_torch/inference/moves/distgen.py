"""Independence MH move drawing from a fixed distribution.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.distgen
.DistributionGenerate``: every walker proposes brand-new coordinates from a
distribution q (a `ProbDistContainer`, unit-cube draws through each
parameter's ``ppf``), with ``log q(old) - log q(new)`` in the MH ratio. A
mode-hopping move to mix with local ones in a schedule. `propose` takes the
flat contract, or the tree contract (`moves.tree`) when ``coords`` is a
dict: then every branch's active leaves are redrawn in one proposal with
summed factors and one accept per walker.
"""

from __future__ import annotations

import torch

from .stretch import Move, _uniform, mh_update
from .tree import tree_evaluate, tree_shapes


def ppf_draw(dist, u: torch.Tensor) -> torch.Tensor:
    """Unit-cube points ``u`` (..., ndim) through the container's ppf of
    each parameter index."""
    return torch.stack([dist.priors_in[i].ppf(u[..., i]) for i in range(u.shape[-1])], dim=-1)


class DistributionGenerate(Move):
    """Independence sampler from ``generate_dist`` (a `ProbDistContainer`,
    or a dict of one per branch, of which the flat contract uses the first).
    Draws: the unit-cube points (ntemps, nwalkers, ndim), then the accept
    uniforms (ntemps, nwalkers); on a tree, `tree_draws`."""

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

    def propose_tree(self, generator, coords, inds, log_like, log_prior, betas, logp_fn,
                     logl_fn):
        """The tree contract: (coords, inds, log_like, log_prior, accepted
        per temperature)."""
        return self.step_tree(coords, inds, log_like, log_prior, betas,
                              self.tree_draws(generator, coords), logp_fn, logl_fn)

    def tree_draws(self, generator, coords):
        """The unit-cube points of every branch in branch order, each of its
        coords' shape, then the accept uniforms (ntemps, nwalkers)."""
        u = {name: _uniform(generator, tuple(c.shape)) for name, c in coords.items()}
        return u, _uniform(generator, tree_shapes(coords))

    def step_tree(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        dists = self.dist if isinstance(self.dist, dict) else {name: self.dist for name in coords}
        u_draw, u = draws
        q = {}
        factors = torch.zeros(tree_shapes(coords), dtype=torch.float64)
        for name, c in coords.items():
            dist = dists[name]
            drawn = ppf_draw(dist, u_draw[name])
            # the active leaves are redrawn; a masked sum, as inactive
            # placeholders may lie outside q (-inf - -inf is NaN)
            q[name] = torch.where(inds[name][..., None], drawn, c)
            factors = factors + torch.sum(
                torch.where(inds[name], dist.logpdf(c) - dist.logpdf(drawn), 0.0), dim=-1)
        lp_new, ll_new = tree_evaluate(q, inds, logp_fn, logl_fn)
        lnpdiff = factors + betas[:, None] * (ll_new - log_like) + lp_new - log_prior
        accept = (torch.log(u) < lnpdiff) & torch.isfinite(lp_new)
        coords = {name: torch.where(accept[..., None, None], q[name], c)
                  for name, c in coords.items()}
        return (coords, inds, torch.where(accept, ll_new, log_like),
                torch.where(accept, lp_new, log_prior), accept.sum(dim=1))

    def draws(self, generator, shape):
        return _uniform(generator, shape), _uniform(generator, shape[:2])

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        dist = self._flat_dist()
        u_draw, u = draws
        q = ppf_draw(dist, u_draw)
        factors = dist.logpdf(coords) - dist.logpdf(q)
        return mh_update(coords, log_like, log_prior, betas, q, factors, u, logp_fn, logl_fn)


__all__ = ["DistributionGenerate", "ppf_draw"]
