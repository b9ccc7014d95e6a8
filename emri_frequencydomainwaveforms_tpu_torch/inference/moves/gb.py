"""Galactic-binary sky moves and the legacy parallel-tempered red-blue move.

Counterpart of the single-branch half of
``emri_frequencydomainwaveforms_tpu.inference.moves.gb``:

* `SkyMove`: discrete hopping between the 8 degenerate LISA sky modes, a
  latitude reflection (sin beta -> -sin beta, cos iota -> -cos iota,
  psi -> pi - psi) and longitude quarter turns (lam, psi += k pi / 2), a
  symmetric MH proposal.
* `MultiSourceFisherProposal`: MH with a block-diagonal covariance, one
  (Fisher-derived) block per source, scaled by a constant ``factor``.
* `PTRedBlueMove`: the legacy parallel-tempered red-blue move, a stretch
  within every rung, the swap cascade and the Vousden ladder adaptation, as
  one object over the port's `StretchMove` and `TemperatureControl`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.periodic import floor_mod
from .gaussian import MHMove
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


__all__ = ["SkyMove", "MultiSourceFisherProposal", "PTRedBlueMove"]
