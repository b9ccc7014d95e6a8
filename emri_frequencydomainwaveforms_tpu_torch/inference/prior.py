"""Prior distributions and the ProbDistContainer.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.prior``:
`UniformDistribution` / `uniform_dist`, `log_uniform`,
`MappedUniformDistribution` and `ProbDistContainer`. ``logpdf`` and ``ppf``
work on float64 tensors (numpy arrays are converted); ``rvs`` draws with
numpy on the host, for walker initialization.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def _rng(random_state):
    if isinstance(random_state, np.random.Generator):
        return random_state
    return np.random.default_rng(random_state)


class UniformDistribution:
    """Uniform on [minimum, maximum]."""

    def __init__(self, minimum: float, maximum: float):
        self.min_val = float(minimum)
        self.max_val = float(maximum)
        self._log_pdf = -math.log(self.max_val - self.min_val)

    def logpdf(self, x):
        x = _f64(x)
        inside = (x >= self.min_val) & (x <= self.max_val)
        return torch.where(inside, torch.full_like(x, self._log_pdf), -math.inf)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def ppf(self, q):
        return self.min_val + _f64(q) * (self.max_val - self.min_val)

    def rvs(self, size=1, random_state=None):
        return _rng(random_state).uniform(self.min_val, self.max_val, size=size)


def uniform_dist(minimum, maximum) -> UniformDistribution:
    return UniformDistribution(minimum, maximum)


class log_uniform:
    """Log-uniform on [minimum, maximum]."""

    def __init__(self, minimum: float, maximum: float):
        self.min_val = float(minimum)
        self.max_val = float(maximum)
        self._norm = math.log(math.log(self.max_val / self.min_val))

    def logpdf(self, x):
        x = _f64(x)
        inside = (x >= self.min_val) & (x <= self.max_val)
        return torch.where(inside, -torch.log(x) - self._norm, -math.inf)

    def ppf(self, q):
        return self.min_val * (self.max_val / self.min_val) ** _f64(q)

    def rvs(self, size=1, random_state=None):
        return self.ppf(_rng(random_state).uniform(size=size)).numpy()


class MappedUniformDistribution(UniformDistribution):
    """Uniform on [minimum, maximum] with its logpdf evaluated in the unit
    coordinates (0 inside, -inf outside)."""

    def map_to_unit(self, x):
        return (_f64(x) - self.min_val) / (self.max_val - self.min_val)

    def logpdf(self, x):
        u = self.map_to_unit(x)
        return torch.where((u >= 0) & (u <= 1), torch.zeros_like(u), -math.inf)


class ProbDistContainer:
    """Parameter indices (int or tuple) -> distribution.

    ``logpdf`` over (..., ndim) sums the component log-pdfs; ``rvs`` draws
    (size, ndim) numpy samples; ``ppf`` maps unit-cube points.
    """

    def __init__(self, priors_in: dict):
        self.priors_in = dict(priors_in)
        self.ndim = 0
        for key in priors_in:
            inds = key if isinstance(key, tuple) else (key,)
            self.ndim = max(self.ndim, max(inds) + 1)

    def logpdf(self, x):
        x = _f64(x)
        out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for key, dist in self.priors_in.items():
            if isinstance(key, tuple):
                out = out + dist.logpdf(torch.stack([x[..., k] for k in key], dim=-1))
            else:
                out = out + dist.logpdf(x[..., key])
        return out

    def ppf(self, q):
        q = _f64(q)
        out = torch.zeros(q.shape[:-1] + (self.ndim,), dtype=q.dtype, device=q.device)
        for key, dist in self.priors_in.items():
            if isinstance(key, tuple):
                raise NotImplementedError("ppf for multi-index distributions")
            out[..., key] = dist.ppf(q[..., key])
        return out

    def rvs(self, size=1, random_state=None):
        if isinstance(size, int):
            size = (size,)
        rng = _rng(random_state)
        out = np.zeros(tuple(size) + (self.ndim,))
        for key, dist in self.priors_in.items():
            if isinstance(key, tuple):
                draw = np.asarray(dist.rvs(size=size, random_state=rng))
                for i, k in enumerate(key):
                    out[..., k] = draw[..., i]
            else:
                out[..., key] = np.asarray(dist.rvs(size=size, random_state=rng))
        return out


__all__ = [
    "UniformDistribution",
    "uniform_dist",
    "log_uniform",
    "MappedUniformDistribution",
    "ProbDistContainer",
]
