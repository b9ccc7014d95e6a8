"""Parallel-tempering ladder, swaps and adaptation.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves
.tempering``: `make_ladder` (geometric spacing toward ~25 % swap
acceptance; ``Tmax=inf`` pins the top rung at beta = 0), the
nearest-neighbour swap cascade from the hottest pair down with permuted
walkers and the accept rule ``log u < dbeta (logL_hot - logL_cold)``, and the
Vousden-Farr-Mandel ladder adaptation (arXiv:1501.05823).

`swap_cascade` is the cascade as a pure function of its random draws (per
pair, the hot and cold permutations and the accept uniforms), over one
coordinate tensor or a multi-branch tree; `TemperatureControl
.temperature_swaps` and `temperature_swaps_tree` draw them from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tstep(ndim: int) -> float:
    # geometric temperature step for ~25 % swap acceptance (Vousden-Farr-Mandel)
    return 1.0 + 2.84 / np.sqrt(ndim)


def make_ladder(ndim: int, ntemps: int | None = None, Tmax: float | None = None) -> np.ndarray:
    """Geometric inverse-temperature ladder, descending from beta = 1."""
    if ntemps is None:
        if Tmax is None:
            raise ValueError("specify ntemps and/or Tmax")
        ntemps = int(np.ceil(np.log(Tmax) / np.log(_tstep(ndim)))) + 1
    step = _tstep(ndim)
    if Tmax is not None and not np.isinf(Tmax) and ntemps > 1:
        step = Tmax ** (1.0 / (ntemps - 1))
    betas = step ** (-np.arange(ntemps, dtype=np.float64))
    if Tmax is not None and np.isinf(Tmax):
        betas[-1] = 0.0
    return betas


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nest of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def swap_cascade(coords, log_like, log_prior, betas, perms_hot, perms_cold, u):
    """Nearest-neighbour swaps from the hottest pair down.

    ``coords``: a (ntemps, nwalkers, ...) tensor, or a nest of dicts, tuples
    and lists of them (a multi-branch ``(coords, inds)`` tree, boolean
    ``inds`` included), each swapped alike; ``log_like`` / ``log_prior``
    (ntemps, nwalkers), ``betas`` (ntemps,); the draws are lists over the
    pairs (ntemps-1, ntemps-2), ..., (1, 0): permutations (nwalkers,) of the
    hot and the cold rung and the accept uniforms (nwalkers,). Returns
    (coords, log_like, log_prior, swap acceptance per pair (ntemps-1,),
    coldest pair first).
    """
    coords = _tree_map(torch.clone, coords)
    log_like, log_prior = log_like.clone(), log_prior.clone()
    ntemps = log_like.shape[0]
    ratios = []
    for j, i in enumerate(range(ntemps - 1, 0, -1)):
        p_hot, p_cold = perms_hot[j].long(), perms_cold[j].long()
        ll_hot = log_like[i, p_hot]
        ll_cold = log_like[i - 1, p_cold]
        dbeta = betas[i - 1] - betas[i]
        sel = torch.log(u[j]) < dbeta * (ll_hot - ll_cold)
        ratios.append(torch.mean(sel.to(torch.float64)))

        def swap(x, i=i, p_hot=p_hot, p_cold=p_cold, sel=sel):
            x_hot, x_cold = x[i, p_hot], x[i - 1, p_cold]
            selx = sel.reshape(sel.shape + (1,) * (x_hot.dim() - 1))
            x[i, p_hot] = torch.where(selx, x_cold, x_hot)
            x[i - 1, p_cold] = torch.where(selx, x_hot, x_cold)
            return x

        coords = _tree_map(swap, coords)
        log_like = swap(log_like)
        log_prior = swap(log_prior)
    swap_frac = torch.stack(ratios[::-1]) if ratios else torch.zeros((0,), dtype=torch.float64)
    return coords, log_like, log_prior, swap_frac


class TemperatureControl:
    """Swap cascade and ladder adaptation over (ntemps, nwalkers) ensembles."""

    def __init__(
        self,
        ndim: int,
        nwalkers: int,
        ntemps: int = 1,
        betas=None,
        Tmax=None,
        adaptive: bool = True,
        adaptation_lag: float = 10000.0,
        adaptation_time: float = 100.0,
        stop_adaptation: int = -1,
        permute: bool = True,
    ):
        if betas is None:
            betas = make_ladder(ndim, ntemps, Tmax)
        self.betas = torch.as_tensor(np.asarray(betas), dtype=torch.float64)
        self.ntemps = len(betas)
        self.nwalkers = nwalkers
        self.adaptive = adaptive and self.ntemps > 1
        self.adaptation_lag = adaptation_lag
        self.adaptation_time = adaptation_time
        self.stop_adaptation = stop_adaptation
        self.permute = permute

    def draws(self, generator: torch.Generator, nwalkers: int):
        """Per pair, hottest first: (hot permutations, cold permutations,
        accept uniforms)."""
        hot, cold, u = [], [], []
        for _ in range(self.ntemps - 1):
            if self.permute:
                hot.append(torch.randperm(nwalkers, generator=generator))
                cold.append(torch.randperm(nwalkers, generator=generator))
            else:
                hot.append(torch.arange(nwalkers))
                cold.append(torch.arange(nwalkers))
            u.append(torch.rand((nwalkers,), generator=generator, dtype=torch.float64))
        return hot, cold, u

    def temperature_swaps(self, generator, coords, log_like, log_prior, betas):
        """The swap cascade on draws from ``generator``. Returns (coords,
        log_like, log_prior, swap acceptance per pair (ntemps-1,))."""
        return swap_cascade(coords, log_like, log_prior, betas,
                            *self.draws(generator, log_like.shape[1]))

    def temperature_swaps_tree(self, generator, tree, log_like, log_prior, betas):
        """The same cascade, on the same draws, over a tree of (ntemps,
        nwalkers, ...) tensors (the multi-branch ``(coords, inds)`` dicts).
        Returns (tree, log_like, log_prior, swap acceptance per pair)."""
        return self.temperature_swaps(generator, tree, log_like, log_prior, betas)

    def adapt_ladder(self, betas, swap_frac, time):
        """One adaptation step: the spacings of the inner rungs move by the
        difference of adjacent swap rates (``swap_frac`` coldest pair first);
        beta[0] = 1 and the top rung stay fixed."""
        if not self.adaptive:
            return betas
        decay = self.adaptation_lag / (time + self.adaptation_lag)
        kappa = decay / self.adaptation_time
        dss = kappa * (swap_frac[:-1] - swap_frac[1:])  # (ntemps-2,)
        ts = 1.0 / torch.clamp_min(betas[:-1], 1e-300)  # temperatures, cold -> hot
        delta_ts = torch.diff(ts) * torch.exp(dss)
        ts_new = torch.cumsum(delta_ts, dim=0) + ts[0]
        out = betas.clone()
        out[1:-1] = 1.0 / ts_new
        return out


__all__ = ["make_ladder", "swap_cascade", "TemperatureControl"]
