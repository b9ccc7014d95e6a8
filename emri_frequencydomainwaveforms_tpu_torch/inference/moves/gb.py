"""Galactic-binary moves and the legacy parallel-tempered red-blue move.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.gb``:

* `SkyMove`: discrete hopping between the 8 degenerate LISA sky modes, a
  latitude reflection (sin beta -> -sin beta, cos iota -> -cos iota,
  psi -> pi - psi) and longitude quarter turns (lam, psi += k pi / 2), a
  symmetric MH proposal.
* `MultiSourceFisherProposal`: MH with a block-diagonal covariance, one
  (Fisher-derived) block per source, scaled by a constant ``factor``.
* `PTRedBlueMove`: the legacy parallel-tempered red-blue move, a stretch
  within every rung, the swap cascade and the Vousden ladder adaptation, as
  one object over the port's `StretchMove` and `TemperatureControl`.
* `GBFreqJump`: an in-model tree move (`moves.tree`) for multi-source GB
  states: one uniformly chosen active leaf per walker gets ``num_try``
  candidates (a relative Gaussian perturbation, a ~20-bin f0 jump, a prior
  redraw of some columns, cosine columns reflected into [-1, 1]), one is
  chosen by tempered likelihood (Gumbel-max) and accepted with the
  symmetric-kernel independent multiple-try ratio.
* `BruteRejectionRJ` (alias `BruteRejection`) and `GBBruteRejectionRJ`:
  RJ births chosen from ``num_brute`` candidates, the multiple-try RJ
  estimator of `moves.mt.MTDistGenMoveRJ`, with greedy argmax selection
  (``take_max_ll``, search mode: detailed balance deliberately broken) and
  a ``point_generator_func`` hook for candidate libraries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.periodic import floor_mod
from ..state import cpu64
from .gaussian import MHMove
from .mt import MTDistGenMoveRJ
from .rj import branch_functions
from .stretch import StretchMove, _normal, _uniform
from .tempering import TemperatureControl, swap_cascade


class SkyMove(MHMove):
    """Discrete sky-mode hopping MH.

    ``ind_map``: the columns ``cosinc``, ``lam``, ``sinbeta`` and ``psi``
    (default the MBH layout 6, 7, 8, 9). ``which``: "both", "lat" or
    "long". Proposal draws: the reflection flags (ntemps, nwalkers), True
    where a uniform < 0.5 (drawn for "both"; "lat" reflects every walker),
    then the quarter turns k in 0..3 (ntemps, nwalkers) (drawn unless
    "lat"); a flag or turn not drawn is None.
    """

    def __init__(self, ind_map: dict | None = None, which: str = "both", periodic=None):
        super().__init__(periodic=periodic)
        if ind_map is None:
            ind_map = dict(cosinc=6, lam=7, sinbeta=8, psi=9)
        if which not in ("both", "lat", "long"):
            raise ValueError("which must be 'both', 'lat', or 'long'")
        self.ind_map = dict(ind_map)
        self.which = which

    def _lat(self, coords, flip):
        m = self.ind_map
        out = coords.clone()
        for col, new in ((m["sinbeta"], -coords[..., m["sinbeta"]]),
                         (m["cosinc"], -coords[..., m["cosinc"]]),
                         (m["psi"], math.pi - coords[..., m["psi"]])):
            out[..., col] = torch.where(flip, new, out[..., col])
        return out

    def _long(self, coords, k):
        m = self.ind_map
        shift = k.to(coords.dtype) * (math.pi / 2.0)
        out = coords.clone()
        for col, period in ((m["psi"], math.pi), (m["lam"], 2 * math.pi)):
            out[..., col] = floor_mod(coords[..., col] + shift,
                                      torch.tensor(period, dtype=coords.dtype))
        return out

    def proposal_draws(self, generator, shape):
        ntemps, nwalkers = shape[:2]
        flip = k = None
        if self.which == "both":
            flip = _uniform(generator, (ntemps, nwalkers)) < 0.5
        if self.which != "lat":
            k = torch.randint(0, 4, (ntemps, nwalkers), generator=generator)
        return flip, k

    def get_proposal(self, coords, draws):
        flip, k = draws
        prop = coords
        if self.which in ("both", "lat"):
            if flip is None:
                flip = torch.ones(coords.shape[:2], dtype=torch.bool)
            prop = self._lat(prop, flip)
        if self.which in ("both", "long"):
            prop = self._long(prop, k)
        # involution (lat) x uniform group shift (long): symmetric, factors 0
        return prop, torch.zeros(coords.shape[:2], dtype=coords.dtype)


class MultiSourceFisherProposal(MHMove):
    """Block-diagonal Fisher-covariance MH.

    ``cov``: (nsystems, d, d) per-source covariance blocks (or one (d, d));
    the sampled vector concatenates the sources' blocks, ndim = nsystems d.
    ``factor`` scales every block. Proposal draws: standard normals
    (ntemps, nwalkers, nsystems, d).
    """

    def __init__(self, cov, factor: float = 1.0, periodic=None):
        super().__init__(periodic=periodic)
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim == 2:
            cov = cov[None]
        self.nsystems, self.d, _ = cov.shape
        self._chols = torch.from_numpy(np.linalg.cholesky(cov))  # (S, d, d)
        self.factor = float(factor)

    def proposal_draws(self, generator, shape):
        return _normal(generator, tuple(shape[:2]) + (self.nsystems, self.d))

    def get_proposal(self, coords, draws):
        ntemps, nwalkers, ndim = coords.shape
        if ndim != self.nsystems * self.d:
            raise ValueError(f"ndim {ndim} != nsystems*d {self.nsystems * self.d}")
        step = torch.einsum("sij,twsj->twsi", self._chols * math.sqrt(self.factor), draws)
        return (coords + step.reshape(ntemps, nwalkers, ndim),
                torch.zeros((ntemps, nwalkers), dtype=coords.dtype))


class PTRedBlueMove:
    """Legacy parallel-tempered red-blue move.

    `propose` runs a stretch within every rung, the swap cascade, and (while
    adapting) one ladder adaptation step; the ladder is host state
    (``self.betas``, numpy) that it updates and returns. Draws: the
    stretch's, then the swaps'.
    """

    def __init__(self, betas, nwalkers: int, ndim: int, *, adaptive=True,
                 nsplits: int = 2, randomize_split: bool = False,
                 live_dangerously: bool = False, adaptation_lag=10000,
                 adaptation_time=100, stop_adaptation: int = -1,
                 a: float = 2.0, periodic=None):
        del nsplits, randomize_split  # the stretch handles its own split
        self.betas = np.asarray(betas, dtype=np.float64)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        if nwalkers < 2 * ndim and not live_dangerously:
            raise RuntimeError(
                "red-blue moves need nwalkers >= 2*ndim (pass live_dangerously=True to override)")
        self.stretch = StretchMove(a=a, periodic=periodic)
        self.control = TemperatureControl(
            ndim, nwalkers, ntemps=len(self.betas), betas=self.betas,
            adaptive=adaptive, adaptation_lag=adaptation_lag,
            adaptation_time=adaptation_time, stop_adaptation=stop_adaptation,
        )
        self.stop_adaptation = stop_adaptation
        self.time = 0
        self.swaps_accepted = np.zeros(max(len(self.betas) - 1, 0))

    def draws(self, generator, shape):
        return self.stretch.draws(generator, shape), self.control.draws(generator, shape[1])

    def propose(self, generator, coords, log_like, log_prior, logp_fn, logl_fn):
        """One PT red-blue iteration drawn from ``generator``: (coords,
        log_like, log_prior, accepted per temperature, betas)."""
        return self.step(coords, log_like, log_prior, self.draws(generator, tuple(coords.shape)),
                         logp_fn, logl_fn)

    def step(self, coords, log_like, log_prior, draws, logp_fn, logl_fn):
        betas = torch.from_numpy(self.betas.copy())
        coords, log_like, log_prior, n_acc = self.stretch.step(
            coords, log_like, log_prior, betas, draws[0], logp_fn, logl_fn)
        coords, log_like, log_prior, swap_frac = swap_cascade(coords, log_like, log_prior, betas,
                                                              *draws[1])
        if len(self.betas) > 1:
            self.swaps_accepted += swap_frac.numpy()
            if self.stop_adaptation < 0 or self.time < self.stop_adaptation:
                self.betas = self.control.adapt_ladder(betas, swap_frac, self.time).numpy()
        self.time += 1
        return coords, log_like, log_prior, n_acc, torch.from_numpy(self.betas.copy())


class GBFreqJump:
    """Multiple-try frequency-jump leaf update (tree contract).

    ``df``: the frequency bin width (Hz); ``factor``: the relative Gaussian
    width; ``f0_ind``: the f0 column (mHz); ``prior_redraw``: the columns
    drawn anew from the prior (through each dist's ``ppf``);
    ``reflect_inds``: cosine columns reflected into [-1, 1]; ``priors``: a
    `ProbDistContainer` or a dict of them per branch; ``spread``: the f0
    jump in bins.
    """

    def __init__(self, df: float, factor: float, *, num_try: int = 10,
                 f0_ind: int = 1, prior_redraw=(2, 3, 4, 5),
                 reflect_inds=(4, 7), priors=None, spread: int = 20):
        self.df = float(df)
        self.factor = float(factor)
        self.num_try = int(num_try)
        self.f0_ind = int(f0_ind)
        self.prior_redraw = tuple(prior_redraw)
        self.reflect_inds = tuple(reflect_inds)
        self.priors = priors
        self.spread = float(spread)

    def _priors(self, coords):
        return self.priors if isinstance(self.priors, dict) else {
            name: self.priors for name in coords}

    def branch_draws(self, generator, shape, prior):
        """For one branch's coords ``shape`` (T, W, L, D): the slot
        uniforms (T, W, L), the relative normals (T, W, J, D), the f0
        normals (T, W, J), the redrawn columns' unit-cube points (T, W, J,
        len(prior_redraw)) (drawn only with a prior and redraw columns,
        else None), the selection uniforms (T, W, J) and the accept
        uniforms (T, W), drawn in that order."""
        t, w, nl, d = shape
        j = self.num_try
        u_slot = _uniform(generator, (t, w, nl))
        n_rel = _normal(generator, (t, w, j, d))
        n_f0 = _normal(generator, (t, w, j))
        u_pr = (_uniform(generator, (t, w, j, len(self.prior_redraw)))
                if prior is not None and self.prior_redraw else None)
        return u_slot, n_rel, n_f0, u_pr, _uniform(generator, (t, w, j)), _uniform(generator, (t, w))

    def draws(self, generator, coords: dict):
        """`branch_draws` of every branch, in branch order."""
        priors = self._priors(coords)
        return [self.branch_draws(generator, tuple(c.shape), priors[name])
                for name, c in coords.items()]

    def _candidates(self, leaf, prior, n_rel, n_f0, u_pr):
        """(T, W, D) current leaves -> (T, W, J, D) candidates."""
        base = leaf[:, :, None, :].expand(-1, -1, self.num_try, -1)
        cand = base * (1.0 + self.factor * n_rel)
        cand[..., self.f0_ind] = base[..., self.f0_ind] + self.spread * self.df * 1e3 * n_f0
        if u_pr is not None:
            for n, col in enumerate(self.prior_redraw):
                cand[..., col] = prior.priors_in[col].ppf(u_pr[..., n])
        for col in self.reflect_inds:
            x = cand[..., col]
            x = torch.where(x > 1.0, x - 2.0 * torch.abs(1.0 - x), x)
            cand[..., col] = torch.where(x < -1.0, x + 2.0 * torch.abs(-1.0 - x), x)
        return cand

    def propose_tree(self, generator, coords: dict, inds: dict, log_like, log_prior, betas,
                     logp_fn, logl_fn):
        """The tree contract: each branch in turn. Returns (coords, inds,
        log_like, log_prior, accepted per temperature)."""
        return self.step(coords, inds, log_like, log_prior, betas, self.draws(generator, coords),
                         logp_fn, logl_fn)

    # the sampler runs in-model tree moves through `propose`
    propose = propose_tree

    def step(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        priors = self._priors(coords)
        coords = dict(coords)
        n_total = None
        for name, draw in zip(list(coords), draws):
            loglike, logprior = branch_functions(coords, inds, name, logp_fn, logl_fn)
            coords[name], log_like, log_prior, n_acc = self._step_branch(
                priors[name], coords[name], inds[name], log_like, log_prior, betas, draw,
                loglike, logprior)
            n_total = n_acc if n_total is None else n_total + n_acc
        return coords, dict(inds), log_like, log_prior, n_total

    def _step_branch(self, prior, coords, inds, log_like, log_prior, betas, draws, loglike,
                     logprior):
        t, w, nl, d = coords.shape
        j = self.num_try
        u_slot, n_rel, n_f0, u_pr, u_sel, u = draws
        # one uniformly chosen active leaf per walker; a walker with none
        # proposes nothing
        any_active = inds.any(dim=-1)
        slot = torch.argmax(torch.where(inds, u_slot, -torch.inf), dim=-1)
        onehot = torch.nn.functional.one_hot(slot, nl).to(torch.bool)
        leaf = torch.gather(coords, 2, slot[..., None, None].expand(-1, -1, 1, d))[:, :, 0]
        cand = self._candidates(leaf, prior, n_rel, n_f0, u_pr)

        coords_j = torch.where(onehot[:, :, None, :, None], cand[:, :, :, None, :],
                               coords[:, :, None].expand(t, w, j, nl, d)).reshape(t, w * j, nl, d)
        inds_j = inds[:, :, None].expand(t, w, j, nl).reshape(t, w * j, nl)
        lp_j = logprior(coords_j, inds_j).reshape(t, w, j)
        need = any_active[..., None] & torch.isfinite(lp_j)
        ll_j = loglike(coords_j, inds_j, need.reshape(t, w * j)).reshape(t, w, j)

        logw = betas[:, None, None] * ll_j + lp_j
        logw = torch.where(torch.isfinite(logw), logw, -torch.inf)
        sel = torch.argmax(logw + -torch.log(-torch.log(u_sel)), dim=-1)
        y = torch.gather(cand, 2, sel[..., None, None].expand(-1, -1, 1, d))[:, :, 0]
        ll_y = torch.gather(ll_j, 2, sel[..., None])[..., 0]
        lp_y = torch.gather(lp_j, 2, sel[..., None])[..., 0]

        # symmetric-kernel I-MTM: the current point in place of the selected draw
        logw_x = betas[:, None] * log_like + log_prior
        num = torch.logsumexp(logw, dim=-1)
        chosen = torch.arange(j)[None, None, :] == sel[..., None]
        den = torch.logaddexp(torch.logsumexp(logw.masked_fill(chosen, -torch.inf), dim=-1),
                              logw_x)
        accept = (torch.log(u) < num - den) & any_active & torch.isfinite(lp_y)
        coords = torch.where((accept[..., None] & onehot)[..., None], y[..., None, :], coords)
        return (coords, torch.where(accept, ll_y, log_like), torch.where(accept, lp_y, log_prior),
                accept.sum(dim=1))


class BruteRejectionRJ(MTDistGenMoveRJ):
    """Brute-force-rejection RJ births: `MTDistGenMoveRJ` with

    * ``num_brute``: the candidate cloud's size (``num_try``);
    * ``take_max_ll``: greedy argmax selection (search mode; the acceptance
      estimator is unchanged, so detailed balance is deliberately broken);
    * ``point_generator_func(generator, shape) -> (candidates, logq)``:
      candidates (T, W, J, D) from a search-sample library in place of
      ``ppf`` draws, drawn from the iteration's ``torch.Generator`` (the
      reference passes a JAX key). ``logq`` is not folded into the weights:
      the candidates are weighed by ``generate_dist``'s logpdf, as in the
      reference.
    """

    def __init__(self, generate_dist, num_brute: int = 10, *, take_max_ll: bool = False,
                 point_generator_func=None, nleaves_min=0, nleaves_max=1, **kwargs):
        super().__init__(generate_dist, num_try=num_brute, nleaves_min=nleaves_min,
                         nleaves_max=nleaves_max, **kwargs)
        self.num_brute = int(num_brute)
        self.take_max_ll = bool(take_max_ll)
        self._greedy_select = bool(take_max_ll)
        self.point_generator_func = point_generator_func

    def _cand_draws(self, generator, shape):
        if self.point_generator_func is not None:
            return cpu64(self.point_generator_func(generator, shape)[0])
        return super()._cand_draws(generator, shape)

    def _candidates(self, dist, draw):
        if self.point_generator_func is not None:
            return draw
        return super()._candidates(dist, draw)


class GBBruteRejectionRJ(BruteRejectionRJ):
    """`BruteRejectionRJ` under the galactic-binary name; the data and PSD
    it would hold live in `lisa.likelihood.GlobalLikelihood`."""


# the selection core's other name
BruteRejection = BruteRejectionRJ


__all__ = ["SkyMove", "MultiSourceFisherProposal", "GBFreqJump", "BruteRejection",
           "BruteRejectionRJ", "GBBruteRejectionRJ", "PTRedBlueMove"]
