"""Group stretch, delayed rejection and move composition.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.group``:

* `GroupStretchMove`: a stretch toward a frozen "friends" snapshot (set
  with `set_friends`) instead of the live other half, with the
  Goodman-Weare factor ``(ndim - 1) log z``; while no friends are set it is
  the live two-half `StretchMove`.
* `DelayedRejectionMove`: a two-stage Gaussian random walk. Both stages are
  evaluated; stage 2 starts from the original point with a
  ``scale_2``-shrunk step and counts only where stage 1 rejected, with the
  Tierney-Mira ratio.
* `CombineMove`: several moves applied in turn within one proposal.
"""

from __future__ import annotations

import torch

from .stretch import Move, StretchMove, _diff, _normal, _uniform, _wrap, evaluate, mh_update


class GroupStretchMove(StretchMove):
    """Stretch move against a frozen friends ensemble ((n_friends, ndim),
    shared by the temperatures, or (ntemps, n_friends, ndim)). Draws with
    friends: z (ntemps, nwalkers) = ((a - 1) U + 1)^2 / a, the friend
    indices (ntemps, nwalkers), the accept uniforms (ntemps, nwalkers), in
    that order; without: `StretchMove`'s."""

    def __init__(self, friends=None, n_friends: int | None = None, **kwargs):
        super().__init__(**kwargs)
        self.friends = None if friends is None else torch.as_tensor(friends, dtype=torch.float64)
        self.n_friends = n_friends

    def set_friends(self, friends):
        """Install a new stationary complement (e.g. the current best walkers)."""
        self.friends = torch.as_tensor(friends, dtype=torch.float64)

    def find_friends(self, coords):
        """Default friends selection: the current coords snapshot."""
        self.set_friends(coords)

    def draws(self, generator, shape):
        if self.friends is None:
            return super().draws(generator, shape)
        ntemps, nwalkers = shape[:2]
        a = self.a
        z = ((a - 1.0) * _uniform(generator, (ntemps, nwalkers)) + 1.0) ** 2 / a
        pick = torch.randint(0, self.friends.shape[-2], (ntemps, nwalkers), generator=generator)
        return z, pick, _uniform(generator, (ntemps, nwalkers))

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        if self.friends is None:
            return super().step(coords, log_like, log_prior, betas, draws, logp_fn, logl_fn)
        ntemps, nwalkers, ndim = coords.shape
        z, pick, u = draws
        friends = self.friends
        if friends.dim() == 2:
            friends = friends.expand(ntemps, -1, -1)
        c_pick = torch.gather(friends, 1, pick[..., None].expand(-1, -1, ndim))
        prop = _wrap(torch.addcmul(c_pick, z[..., None], _diff(coords, c_pick, self.periodic)),
                     self.periodic)
        return mh_update(coords, log_like, log_prior, betas, prop, (ndim - 1.0) * torch.log(z), u,
                         logp_fn, logl_fn)


def _log1m(la):
    """log(1 - exp(la)), the exponential clipped at 1 - 1e-15."""
    return torch.log1p(-torch.clamp(torch.exp(la), max=1.0 - 1e-15))


class DelayedRejectionMove(Move):
    """Two-stage delayed-rejection Gaussian random walk.

    Stage 1: step ~ N(0, sigma^2); stage 2 (where stage 1 rejected): step
    ~ N(0, (scale_2 sigma)^2) from the original point, accepted with

      alpha_2 = min(1, [pi(y2) (1 - alpha_1(y2 -> y1))]
                       / [pi(x) (1 - alpha_1(x -> y1))]).

    ``sigma``: scalar or (ndim,). Draws: the stage-1 and stage-2 normals
    (ntemps, nwalkers, ndim), then the stage-1 and stage-2 accept uniforms
    (ntemps, nwalkers), in that order. Each stage's likelihood call takes
    only its proposals inside the prior.
    """

    def __init__(self, sigma, scale_2: float = 0.25, periodic=None, **kwargs):
        del kwargs
        self.sigma = torch.as_tensor(sigma, dtype=torch.float64)
        self.scale_2 = scale_2
        self.periodic = periodic

    def draws(self, generator, shape):
        n1, n2 = _normal(generator, shape), _normal(generator, shape)
        return n1, n2, _uniform(generator, shape[:2]), _uniform(generator, shape[:2])

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        n1, n2, u1, u2 = draws
        b = betas[:, None]
        y1 = _wrap(coords + n1 * self.sigma, self.periodic)
        lp1, ll1 = evaluate(y1, logp_fn, logl_fn)
        lnp_x = b * log_like + log_prior
        lnp_1 = b * ll1 + lp1
        log_a1 = torch.clamp(lnp_1 - lnp_x, max=0.0)
        acc1 = (torch.log(u1) < log_a1) & torch.isfinite(lp1)

        y2 = _wrap(coords + n2 * (self.scale_2 * self.sigma), self.periodic)
        lp2, ll2 = evaluate(y2, logp_fn, logl_fn)
        lnp_2 = b * ll2 + lp2
        log_a1_rev = torch.clamp(lnp_1 - lnp_2, max=0.0)
        log_a2 = torch.clamp(lnp_2 + _log1m(log_a1_rev) - lnp_x - _log1m(log_a1), max=0.0)
        acc2 = (torch.log(u2) < log_a2) & torch.isfinite(lp2) & ~acc1

        coords = torch.where(acc1[..., None], y1, torch.where(acc2[..., None], y2, coords))
        log_like = torch.where(acc1, ll1, torch.where(acc2, ll2, log_like))
        log_prior = torch.where(acc1, lp1, torch.where(acc2, lp2, log_prior))
        return coords, log_like, log_prior, (acc1 | acc2).sum(dim=1)


class CombineMove(Move):
    """Several moves applied in turn within one proposal; the draws are
    each move's draws, in the moves' order."""

    def __init__(self, moves):
        self.moves = list(moves)
        self.periodic = None

    def draws(self, generator, shape):
        return [m.draws(generator, shape) for m in self.moves]

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        n_acc = None
        for m, d in zip(self.moves, draws):
            coords, log_like, log_prior, acc = m.step(coords, log_like, log_prior, betas, d,
                                                      logp_fn, logl_fn)
            n_acc = acc if n_acc is None else n_acc + acc
        return coords, log_like, log_prior, n_acc


__all__ = ["GroupStretchMove", "DelayedRejectionMove", "CombineMove"]
