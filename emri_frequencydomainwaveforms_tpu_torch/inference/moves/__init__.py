"""Ensemble moves. The flat (ntemps, nwalkers, ndim) contract: stretch,
Gaussian / AM / DE random walks, independence and multiple-try draws, group
stretch, delayed rejection, composition, DIME, the sky and Fisher moves and
the legacy parallel-tempered red-blue move. The tree contract over
multi-branch states: the tree stretch and Gaussian moves, distribution
draws, the reversible-jump birth / death moves (prior draws, delayed
rejection, multiple try, brute rejection) and the GB frequency jump. And
the tempering ladder."""

from .distgen import DistributionGenerate
from .gaussian import GaussianMove, MHMove
from .gb import (
    BruteRejectionRJ,
    GBBruteRejectionRJ,
    GBFreqJump,
    MultiSourceFisherProposal,
    PTRedBlueMove,
    SkyMove,
)
from .group import CombineMove, DelayedRejectionMove, GroupStretchMove
from .mt import MTDistGenMove, MTDistGenMoveRJ
from .rj import DelayedRejectionRJ, DistributionGenerateRJ
from .stretch import DIMEMove, DIMEState, StretchMove
from .tempering import TemperatureControl, make_ladder
from .tree import TreeGaussianMove, TreeStretchMove

__all__ = [
    "GaussianMove",
    "MHMove",
    "BruteRejectionRJ",
    "GBBruteRejectionRJ",
    "GBFreqJump",
    "MultiSourceFisherProposal",
    "PTRedBlueMove",
    "SkyMove",
    "CombineMove",
    "DelayedRejectionMove",
    "GroupStretchMove",
    "MTDistGenMove",
    "MTDistGenMoveRJ",
    "DistributionGenerate",
    "DelayedRejectionRJ",
    "DistributionGenerateRJ",
    "StretchMove",
    "DIMEMove",
    "DIMEState",
    "TemperatureControl",
    "make_ladder",
    "TreeGaussianMove",
    "TreeStretchMove",
]
