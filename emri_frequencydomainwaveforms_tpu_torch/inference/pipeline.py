"""Staged analysis pipeline: shared state, stages and their orchestration.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.pipeline``:
`InfoManager` (the shared data and whatever the stages publish),
`PipelineModule` (the stage interface), `PipelineGuide` (stages in turn),
`SamplerModule` (a sampler stage around a `guide.SamplerGuide`: a search
from prior draws with an optional SNR stop, or a PE stage started around a
previous stage's best point) and `ResidualUpdateModule` (subtracts the
template at a published point from the shared data).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch


class InfoManager:
    """Shared pipeline state: the frequency grid, the data channels and
    every attribute a stage publishes."""

    def __init__(self, name=None, data=None, dt=None, T=None, fd=None, **kwargs):
        self.name = name
        self.dt, self.T, self.fd = dt, T, fd
        if data is not None:
            self.data = data
        for key, value in kwargs.items():
            setattr(self, key, value)

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, data):
        self.nchannels = len(data)
        self.data_length = len(data[0])
        self._data = data

    def update_info(self, data, *args, **kwargs):
        self.data = data


class PipelineModule(ABC):
    """One pipeline stage."""

    def __init__(self, name=None):
        self.name = name

    @abstractmethod
    def update_module(self, info_manager, *args, **kwargs):
        """Receive the shared state before running."""

    @abstractmethod
    def run_module(self, progress=False, **kwargs):
        """Run the stage."""

    def update_information(self, info_manager, *args, **kwargs):
        """Publish the stage's outputs into the shared state."""


class PipelineGuide:
    """The stages, in turn, over one `InfoManager`."""

    def __init__(self, info_manager: InfoManager, module_list):
        self.module_list = list(module_list)
        self.info_manager = info_manager

    def run(self, progress=False, verbose=False, **update_kwargs):
        for i, module in enumerate(self.module_list):
            label = f": {module.name}" if module.name else ""
            if verbose:
                print(f"starting module {i}{label}")
            module.update_module(self.info_manager, **update_kwargs)
            module.run_module(progress=progress)
            module.update_information(self.info_manager)
            if verbose:
                print(f"finished module {i}{label}")


class SamplerModule(PipelineModule):
    """A sampler stage around a `guide.SamplerGuide`.

    Args:
      guide: the preset whose `build` makes the sampler.
      nsteps / burn: the sampling schedule.
      start: the start coordinates (ntemps, nwalkers, [1,] ndim), else a
        ball around the InfoManager's ``seed_from`` attribute, else draws
        from the guide's priors (numpy, seeded with the guide's seed).
      seed_from: the attribute holding a previous stage's best point.
      publish_best: the attribute under which this stage publishes its
        maximum-likelihood point (and ``<publish_best>_loglike``).
      stopping_snr: stop early once the maximum log L reaches
        -stopping_snr^2 / 2 (checked every iteration).
    """

    def __init__(self, guide, nsteps: int, burn: int = 0, start=None,
                 seed_from: str | None = None, publish_best: str = "best_point",
                 stopping_snr: float | None = None, name=None):
        super().__init__(name=name)
        self.guide = guide
        self.nsteps = nsteps
        self.burn = burn
        self.start = start
        self.seed_from = seed_from
        self.publish_best = publish_best
        self.stopping_snr = stopping_snr
        self.sampler = None
        self.last_state = None

    def update_module(self, info_manager, **kwargs):
        self.info_manager = info_manager

    def run_module(self, progress=False, **kwargs):
        ens = self.guide.build()
        self.sampler = ens
        if self.start is not None:
            start = self.start
        elif self.seed_from is not None:
            center = np.asarray(getattr(self.info_manager, self.seed_from))
            start = self.guide.start_from_ball(center, rel_scale=1e-4)
        else:
            start = torch.from_numpy(self.guide.priors.rvs(
                size=(self.guide.ntemps, self.guide.nwalkers),
                random_state=self.guide.seed))[:, :, None, :]
        if self.stopping_snr is not None:
            target = 0.5 * self.stopping_snr**2

            def stopping(i, state, sampler):
                best = float(torch.max(state.log_like))
                return best >= -1e290 and best + target >= 0.0

            ens.stopping_fn = stopping
            ens.stopping_iterations = 1
        self.last_state = ens.run_mcmc(start, self.nsteps, burn=self.burn)

    def update_information(self, info_manager, **kwargs):
        chain = self.sampler.get_chain()
        name = self.sampler.branch_names[0]
        coords = chain[name][:, 0].reshape(-1, self.guide.priors.ndim)
        ll = self.sampler.get_log_like()[:, 0, :].ravel()
        finite = np.isfinite(coords[:, 0])
        coords, ll = coords[finite], ll[finite]
        setattr(info_manager, self.publish_best, coords[int(np.argmax(ll))])
        setattr(info_manager, f"{self.publish_best}_loglike", float(ll.max()))


class ResidualUpdateModule(PipelineModule):
    """Subtract the template at a published point from the shared data
    (iterative source extraction). ``template_fn(params) -> [channels]``
    on the InfoManager's grid."""

    def __init__(self, template_fn, best_attr: str = "best_point", name=None):
        super().__init__(name=name)
        self.template_fn = template_fn
        self.best_attr = best_attr

    def update_module(self, info_manager, **kwargs):
        self.info_manager = info_manager

    def run_module(self, progress=False, **kwargs):
        best = np.asarray(getattr(self.info_manager, self.best_attr))
        tmpl = self.template_fn(best)
        self.info_manager.update_info(
            [np.asarray(d) - np.asarray(t) for d, t in zip(self.info_manager.data, tmpl)])


__all__ = ["InfoManager", "PipelineModule", "PipelineGuide", "SamplerModule",
           "ResidualUpdateModule"]
