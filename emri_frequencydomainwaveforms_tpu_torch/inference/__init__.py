"""Ensemble MCMC: the tempered sampler (fixed dimension or multi-branch /
reversible jump) and its move schedule, the moves, priors, state, chain
backends, the stopping / update hooks, the sampler presets and the staged
pipeline."""

from .backends.hdf import HDFBackend, TempHDFBackend
from .backends.memory import Backend
from .ensemble import EnsembleSampler
from .moves.distgen import DistributionGenerate
from .moves.gaussian import GaussianMove, MHMove
from .moves.gb import MultiSourceFisherProposal, PTRedBlueMove, SkyMove
from .moves.group import CombineMove, DelayedRejectionMove, GroupStretchMove
from .moves.mt import MTDistGenMove, MTDistGenMoveRJ
from .moves.rj import DelayedRejectionRJ, DistributionGenerateRJ
from .moves.stretch import DIMEMove, StretchMove
from .moves.tempering import TemperatureControl, make_ladder
from .moves.tree import TreeGaussianMove, TreeStretchMove
from .pipeline import (
    InfoManager,
    PipelineGuide,
    PipelineModule,
    ResidualUpdateModule,
    SamplerModule,
)
from .prior import (
    MappedUniformDistribution,
    ProbDistContainer,
    UniformDistribution,
    log_uniform,
    uniform_dist,
)
from .state import Branch, BranchSupplimental, State, make_state
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
    "DistributionGenerateRJ",
    "DistributionGenerate",
    "MTDistGenMoveRJ",
    "DelayedRejectionRJ",
    "TemperatureControl",
    "make_ladder",
    "ProbDistContainer",
    "UniformDistribution",
    "uniform_dist",
    "log_uniform",
    "MappedUniformDistribution",
    "State",
    "Branch",
    "BranchSupplimental",
    "make_state",
    "Backend",
    "HDFBackend",
    "TempHDFBackend",
    "SearchConvergeStopping",
    "AutoCorrelationStop",
    "SNRStop",
    "AdjustStretchProposalScale",
]
