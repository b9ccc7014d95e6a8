"""Sampler state.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.state``
(`Branch`, `State`, `make_state`) for the single-branch, fixed-dimension
sampler: float64 CPU tensors, with coords (ntemps, nwalkers, nleaves_max,
ndim) and a boolean leaf mask ``inds``. ``random_state`` holds the integer
seed of the sampler's next iteration (`ensemble.EnsembleSampler` draws each
iteration from a ``torch.Generator`` seeded with it), where the reference
holds a JAX PRNG key. ``move_info`` carries the moves' adaptation state
(`moves.stretch.DIMEState`) from one iteration to the next; the backends do
not store it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class Branch(NamedTuple):
    """One model family's walker coordinates: coords (ntemps, nwalkers,
    nleaves_max, ndim) and the leaf activation ``inds`` (ntemps, nwalkers,
    nleaves_max)."""

    coords: torch.Tensor
    inds: torch.Tensor

    @property
    def shape(self):
        return self.coords.shape

    @property
    def nleaves(self):
        return torch.sum(self.inds, dim=-1)


class State(NamedTuple):
    """Full sampler state: branches, cached posteriors, ladder, seed."""

    branches: dict[str, Branch]
    log_like: torch.Tensor  # (ntemps, nwalkers)
    log_prior: torch.Tensor
    betas: torch.Tensor  # (ntemps,)
    random_state: int | None
    blobs: Any = None
    # per-move adaptation state: a tuple aligned with the sampler's moves,
    # None for the stateless ones
    move_info: Any = None

    @property
    def branches_coords(self):
        return {k: b.coords for k, b in self.branches.items()}

    @property
    def branches_inds(self):
        return {k: b.inds for k, b in self.branches.items()}

    def get_log_posterior(self, temper: bool = False):
        if temper:
            return self.betas[:, None] * self.log_like + self.log_prior
        return self.log_like + self.log_prior


def cpu64(x) -> torch.Tensor:
    """``x`` as a float64 CPU tensor (the sampler's arrays live there)."""
    return torch.as_tensor(x).to(device="cpu", dtype=torch.float64)


def make_state(
    coords,
    log_like=None,
    log_prior=None,
    betas=None,
    inds=None,
    random_state=None,
    blobs=None,
    name: str = "model_0",
) -> State:
    """Build a State from raw arrays: ``coords`` (ntemps, nwalkers,
    [nleaves_max,] ndim) or a dict of such arrays per branch."""
    if not isinstance(coords, dict):
        coords = {name: coords}
    branches = {}
    for k, c in coords.items():
        c = cpu64(c)
        if c.dim() == 3:
            c = c[:, :, None, :]
        if isinstance(inds, dict) and k in inds:
            b_inds = torch.as_tensor(inds[k]).to(torch.bool).cpu()
        else:
            b_inds = torch.ones(c.shape[:-1], dtype=torch.bool)
        branches[k] = Branch(coords=c, inds=b_inds)
    ntemps, nwalkers = next(iter(branches.values())).coords.shape[:2]
    zeros = torch.zeros((ntemps, nwalkers), dtype=torch.float64)
    return State(
        branches=branches,
        log_like=zeros.clone() if log_like is None else cpu64(log_like),
        log_prior=zeros.clone() if log_prior is None else cpu64(log_prior),
        betas=torch.ones((ntemps,), dtype=torch.float64) if betas is None else cpu64(betas),
        random_state=random_state,
        blobs=blobs,
    )


__all__ = ["Branch", "State", "make_state"]
