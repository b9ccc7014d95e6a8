"""Ensemble MCMC: the tempered stretch-move sampler, priors, state, chain
backends and the stopping / update hooks (single branch, fixed dimension)."""

from .backends.hdf import HDFBackend, TempHDFBackend
from .backends.memory import Backend
from .ensemble import EnsembleSampler
from .moves.stretch import StretchMove
from .moves.tempering import TemperatureControl, make_ladder
from .prior import (
    MappedUniformDistribution,
    ProbDistContainer,
    UniformDistribution,
    log_uniform,
    uniform_dist,
)
from .state import Branch, State, make_state
from .stopping import (
    AdjustStretchProposalScale,
    AutoCorrelationStop,
    SearchConvergeStopping,
    SNRStop,
)

__all__ = [
    "EnsembleSampler",
    "StretchMove",
    "TemperatureControl",
    "make_ladder",
    "ProbDistContainer",
    "UniformDistribution",
    "uniform_dist",
    "log_uniform",
    "MappedUniformDistribution",
    "State",
    "Branch",
    "make_state",
    "Backend",
    "HDFBackend",
    "TempHDFBackend",
    "SearchConvergeStopping",
    "AutoCorrelationStop",
    "SNRStop",
    "AdjustStretchProposalScale",
]
