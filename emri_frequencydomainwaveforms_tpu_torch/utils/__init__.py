"""Shared utilities: constants, spin-weighted harmonics, transforms,
windows, FFT helpers, autocorrelation times and the choice of device."""

from . import constants
from .autocorr import autocorr_gw2010, autocorr_new, get_acf, get_integrated_act
from .fdutils import (
    get_convolution,
    get_fd_waveform_fromFD,
    get_fd_waveform_fromTD,
    get_fd_windowed,
    get_fft_td_windowed,
)
from .periodic import PeriodicContainer
from .transform import TransformContainer
from .windows import WINDOWS, blackman, boxcar, hann, nuttall
from .ylm import GetYlms, spin_weighted_ylm

__all__ = [
    "constants",
    "GetYlms",
    "spin_weighted_ylm",
    "TransformContainer",
    "PeriodicContainer",
    "get_convolution",
    "get_fft_td_windowed",
    "get_fd_windowed",
    "get_fd_waveform_fromFD",
    "get_fd_waveform_fromTD",
    "boxcar",
    "hann",
    "blackman",
    "nuttall",
    "WINDOWS",
    "get_acf",
    "get_integrated_act",
    "autocorr_gw2010",
    "autocorr_new",
]
