"""Ensemble MCMC: the tempered sampler and its move schedule, the moves,
priors, state, chain backends and the stopping / update hooks (single
branch, fixed dimension)."""

from .backends.hdf import HDFBackend, TempHDFBackend
from .backends.memory import Backend
from .ensemble import EnsembleSampler
from .moves.distgen import DistributionGenerate
from .moves.gaussian import GaussianMove, MHMove
from .moves.gb import MultiSourceFisherProposal, PTRedBlueMove, SkyMove
from .moves.group import CombineMove, DelayedRejectionMove, GroupStretchMove
from .moves.mt import MTDistGenMove
from .moves.stretch import DIMEMove, StretchMove
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
    "GaussianMove",
    "MHMove",
    "DistributionGenerate",
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
