"""Periodic-parameter handling for ensemble moves.

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.periodic``
(`PeriodicContainer`): shortest signed distances and wrapping for
angle-like parameters, keyed by branch name and parameter index. Works on
float64 tensors (numpy arrays are converted).
"""

from __future__ import annotations

import torch


def floor_mod(x, y):
    """x mod y with the sign of y, from the exact fmod: numpy's and JAX's
    float mod (``torch.remainder`` rounds differently in the last bit)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


class PeriodicContainer:
    """Distance / wrap helpers over {branch: {param_index: period}}."""

    def __init__(self, periodic: dict):
        self.periodic = {k: dict(v) for k, v in periodic.items()} if periodic else {}

    def _vectors(self, name: str, ndim: int, device):
        inds = sorted(self.periodic.get(name, {}))
        mask = torch.zeros((ndim,), dtype=torch.bool, device=device)
        pvec = torch.ones((ndim,), dtype=torch.float64, device=device)
        for i in inds:
            mask[i] = True
            pvec[i] = float(self.periodic[name][i])
        return mask, pvec

    def _dist(self, name, x1, x2):
        x1 = torch.as_tensor(x1, dtype=torch.float64)
        x2 = torch.as_tensor(x2, dtype=torch.float64)
        mask, period = self._vectors(name, x1.shape[-1], x1.device)
        d = x2 - x1
        return torch.where(mask, d - period * torch.round(d / period), d)

    def _wrap(self, name, x):
        x = torch.as_tensor(x, dtype=torch.float64)
        mask, period = self._vectors(name, x.shape[-1], x.device)
        return torch.where(mask, floor_mod(x, period), x)

    def distance(self, p1: dict, p2: dict) -> dict:
        """Shortest signed distance p2 - p1 per branch."""
        return {name: self._dist(name, x1, p2[name]) for name, x1 in p1.items()}

    def wrap(self, params: dict) -> dict:
        """Wrap periodic components into [0, period) per branch."""
        return {name: self._wrap(name, x) for name, x in params.items()}

    def wrap_array(self, name: str, x):
        """Array-level wrap for a single branch."""
        return self._wrap(name, x)

    def distance_array(self, name: str, x1, x2):
        return self._dist(name, x1, x2)


__all__ = ["floor_mod", "PeriodicContainer"]
