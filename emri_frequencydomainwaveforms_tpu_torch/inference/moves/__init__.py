"""Ensemble moves over the single-branch (ntemps, nwalkers, ndim) contract:
stretch, Gaussian / AM / DE random walks, independence and multiple-try
draws, group stretch, delayed rejection, composition, DIME, the sky and
Fisher moves, the legacy parallel-tempered red-blue move, and the
tempering ladder."""

from .distgen import DistributionGenerate
from .gaussian import GaussianMove, MHMove
from .gb import MultiSourceFisherProposal, PTRedBlueMove, SkyMove
from .group import CombineMove, DelayedRejectionMove, GroupStretchMove
from .mt import MTDistGenMove
from .stretch import DIMEMove, DIMEState, StretchMove
from .tempering import TemperatureControl, make_ladder

__all__ = [
    "GaussianMove",
    "MHMove",
    "MultiSourceFisherProposal",
    "PTRedBlueMove",
    "SkyMove",
    "CombineMove",
    "DelayedRejectionMove",
    "GroupStretchMove",
    "MTDistGenMove",
    "DistributionGenerate",
    "StretchMove",
    "DIMEMove",
    "DIMEState",
    "TemperatureControl",
    "make_ladder",
]
