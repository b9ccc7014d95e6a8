"""Sampler presets: `SamplerGuide`, `EMRIGuide`, `MBHGuide`, `GBGuide`.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.guide``: each
preset bundles a source class's standard configuration (priors, periodic
parameters, tempering, walker start, backend, and for galactic binaries the
reversible-jump multi-source set-up) and builds an `EnsembleSampler` around
a user's likelihood. The waveform models of MBHs and galactic binaries are
the user's; the presets carry the sampler side.
"""

from __future__ import annotations

import numpy as np
import torch

from .backends.hdf import HDFBackend
from .backends.memory import Backend
from .ensemble import EnsembleSampler
from .prior import ProbDistContainer, uniform_dist


class SamplerGuide:
    """Base preset: likelihood, priors, tempering and backend."""

    branch_name = "model_0"

    def __init__(self, like_fn, priors: ProbDistContainer, *, nwalkers=32, ntemps=1,
                 periodic=None, backend=None, fp=None, info=None, seed=0):
        self.like_fn = like_fn
        self.priors = priors
        self.nwalkers = nwalkers
        self.ntemps = ntemps
        self.periodic = periodic
        if backend is None:
            backend = HDFBackend(fp) if fp else Backend()
        self.backend = backend
        self.info = info or {}
        self.seed = seed

    def _tempering(self):
        return {"ntemps": self.ntemps, "Tmax": np.inf} if self.ntemps > 1 else None

    def build(self) -> EnsembleSampler:
        return EnsembleSampler(
            self.nwalkers, [self.priors.ndim], self.like_fn, {self.branch_name: self.priors},
            tempering_kwargs=self._tempering(), periodic=self.periodic, backend=self.backend,
            branch_names=[self.branch_name], info=self.info, seed=self.seed,
        )

    def start_from_ball(self, center, rel_scale=1e-7, seed=None) -> torch.Tensor:
        """(ntemps, nwalkers, ndim) walkers around ``center``, each parameter
        spread by ``|center| rel_scale + 1e-9`` (numpy draws from ``seed``,
        default the guide's)."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        center = np.asarray(center, dtype=np.float64)
        scales = np.abs(center) * rel_scale + 1e-9
        return torch.from_numpy(
            center[None, None, :]
            + rng.normal(0, 1.0, (self.ntemps, self.nwalkers, len(center))) * scales[None, None, :])


class EMRIGuide(SamplerGuide):
    """EMRI preset: (ln M, ln eta, p0, e0, Phi_phi0, Phi_r0) with the PE
    driver's priors and periodic phases."""

    branch_name = "emri"

    def __init__(self, like_fn, *, p0_center=12.0, **kwargs):
        priors = ProbDistContainer({
            0: uniform_dist(np.log(5e5), np.log(1e7)),
            1: uniform_dist(np.log(1e-6), np.log(1e-4)),
            2: uniform_dist(max(p0_center - 2.0, 7.0), p0_center + 3.0),
            3: uniform_dist(0.001, 0.7),
            4: uniform_dist(0.0, 2 * np.pi),
            5: uniform_dist(0.0, 2 * np.pi),
        })
        kwargs.setdefault("periodic", {"emri": {4: 2 * np.pi, 5: np.pi}})
        super().__init__(like_fn, priors, **kwargs)


class MBHGuide(SamplerGuide):
    """MBH preset: (ln MT, q, chi1, chi2, d_Gpc, phi_ref, cos iota, lam,
    sin beta, psi, t_ref) with their priors, transforms and periodic
    angles."""

    branch_name = "mbh"

    def __init__(self, like_fn, *, Tobs=1.0, **kwargs):
        yr = 365.25 * 24 * 3600.0
        priors = ProbDistContainer({
            0: uniform_dist(np.log(1e5), np.log(1e8)),
            1: uniform_dist(0.01, 0.999999999),
            2: uniform_dist(-0.99999999, 0.99999999),
            3: uniform_dist(-0.99999999, 0.99999999),
            4: uniform_dist(0.01, 1000.0),
            5: uniform_dist(0.0, 2 * np.pi),
            6: uniform_dist(-1.0, 1.0),
            7: uniform_dist(0.0, 2 * np.pi),
            8: uniform_dist(-1.0, 1.0),
            9: uniform_dist(0.0, np.pi),
            10: uniform_dist(0.0, Tobs * yr),
        })
        kwargs.setdefault("periodic", {"mbh": {5: 2 * np.pi, 7: 2 * np.pi, 9: np.pi}})
        super().__init__(like_fn, priors, **kwargs)

    @staticmethod
    def parameter_transforms():
        """Sampled -> physical maps on float64 tensors: exp of ln MT,
        (MT, q) -> (m1, m2), Gpc -> m, arccos / arcsin of the angle
        cosines."""
        from ..utils.constants import PC_SI

        def mt_q(ln_mt, q):
            mt = torch.exp(torch.as_tensor(ln_mt, dtype=torch.float64))
            q = torch.as_tensor(q, dtype=torch.float64)
            return [mt / (1.0 + q), mt * q / (1.0 + q)]

        return {
            (0, 1): mt_q,
            4: lambda x: x * PC_SI * 1e9,
            7: torch.arccos,
            9: torch.arcsin,
        }

    @staticmethod
    def relbin_likelihood(template_fn, f_dense, data, h0, psd, max_bins=512, device=None):
        """The heterodyned likelihood of a search -> PE hand-off:
        ``template_fn`` runs at the coarse bin edges only. Returns a
        `lisa.relbin.RelativeBinningLikelihood` to pass as ``like_fn``."""
        from ..lisa.relbin import RelativeBinningLikelihood

        return RelativeBinningLikelihood(template_fn, f_dense, data, h0, psd, max_bins=max_bins,
                                         device=device)


class GBGuide(SamplerGuide):
    """Galactic-binary preset: (ln A, f0 mHz, fdot, phi0, cos iota, psi, lam,
    sin beta); with ``nleaves_max > 1`` the reversible-jump multi-source
    sampler, births drawn from the prior."""

    branch_name = "gb"

    def __init__(self, like_fn, *, nleaves_max=1, nleaves_min=0, **kwargs):
        priors = ProbDistContainer({
            0: uniform_dist(np.log(1e-24), np.log(1e-20)),
            1: uniform_dist(0.5, 20.0),
            2: uniform_dist(1e-20, 1e-13),
            3: uniform_dist(0.0, 2 * np.pi),
            4: uniform_dist(-1.0, 1.0),
            5: uniform_dist(0.0, np.pi),
            6: uniform_dist(0.0, 2 * np.pi),
            7: uniform_dist(-1.0, 1.0),
        })
        kwargs.setdefault("periodic", {"gb": {3: 2 * np.pi, 5: np.pi, 6: 2 * np.pi}})
        self.nleaves_max = nleaves_max
        self.nleaves_min = nleaves_min
        super().__init__(like_fn, priors, **kwargs)

    def build(self) -> EnsembleSampler:
        if self.nleaves_max <= 1:
            return super().build()
        return EnsembleSampler(
            self.nwalkers, {self.branch_name: self.priors.ndim}, self.like_fn,
            {self.branch_name: self.priors}, tempering_kwargs=self._tempering(),
            backend=self.backend, branch_names=[self.branch_name],
            nleaves_max={self.branch_name: self.nleaves_max},
            nleaves_min={self.branch_name: self.nleaves_min},
            rj_moves=True, info=self.info, seed=self.seed,
        )


__all__ = ["SamplerGuide", "MBHGuide", "GBGuide", "EMRIGuide"]
