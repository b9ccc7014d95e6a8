"""Sampler state.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.state``
(`Branch`, `State`, `make_state`, `BranchSupplimental`): float64 CPU
tensors, with coords (ntemps, nwalkers, nleaves_max, ndim) and a boolean
leaf mask ``inds`` per branch. ``random_state`` holds the integer
seed of the sampler's next iteration (`ensemble.EnsembleSampler` draws each
iteration from a ``torch.Generator`` seeded with it), where the reference
holds a JAX PRNG key. ``move_info`` carries the moves' adaptation state
(`moves.stretch.DIMEState`) from one iteration to the next; the backends do
not store it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
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


class BranchSupplimental:
    """Host-side numpy data keyed like a branch: per-leaf arrays that follow
    walker reshuffles by take / put along an axis."""

    def __init__(self, obj_info: dict, base_shape=None):
        self.holder = {k: np.asarray(v) for k, v in obj_info.items()}
        self.base_shape = base_shape

    def __getitem__(self, key):
        return self.holder[key]

    @staticmethod
    def _expand(indices, ndim):
        return indices.reshape(indices.shape + (1,) * (ndim - indices.ndim))

    def take_along_axis(self, indices, axis: int):
        indices = np.asarray(indices)
        return {k: np.take_along_axis(v, self._expand(indices, v.ndim), axis=axis)
                for k, v in self.holder.items()}

    def put_along_axis(self, indices, values: dict, axis: int):
        indices = np.asarray(indices)
        for k, v in values.items():
            np.put_along_axis(self.holder[k], self._expand(indices, self.holder[k].ndim), v,
                              axis=axis)


__all__ = ["Branch", "State", "make_state", "BranchSupplimental"]
