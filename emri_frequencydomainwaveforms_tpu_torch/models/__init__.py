"""Trajectory, amplitudes and their data-driven backends, mode selection, FD
and TD summation, the batched waveform module and the waveform facades."""

from .amplitude import ModeTable, default_mode_table, mode_amplitudes, NewtonianAmplitude
from .amplitude_backends import Interp2DAmplitude, RomanAmplitude, build_amplitude_grid
from .geodesic import fundamental_frequencies, separatrix, energy_angmom
from .inspiral import (
    EMRIInspiral,
    Trajectory,
    get_mu_at_t,
    get_p_at_t,
    inspiral_duration,
    schwarz_ecc_flux_inspiral,
)
from .modeselect import ModeSelector, SelectedModes, select_modes
from .waveform import (
    FastSchwarzschildEccentricFlux,
    GenerateEMRIWaveform,
    fd_waveform_core,
    td_waveform_core,
    waveform_prologue,
)
from .utility import SchwarzschildEccentric, get_mismatch, get_overlap

__all__ = [
    "ModeTable",
    "default_mode_table",
    "mode_amplitudes",
    "NewtonianAmplitude",
    "Interp2DAmplitude",
    "RomanAmplitude",
    "build_amplitude_grid",
    "fundamental_frequencies",
    "separatrix",
    "energy_angmom",
    "EMRIInspiral",
    "Trajectory",
    "get_p_at_t",
    "get_mu_at_t",
    "inspiral_duration",
    "schwarz_ecc_flux_inspiral",
    "ModeSelector",
    "SelectedModes",
    "select_modes",
    "FastSchwarzschildEccentricFlux",
    "GenerateEMRIWaveform",
    "fd_waveform_core",
    "td_waveform_core",
    "waveform_prologue",
    "SchwarzschildEccentric",
    "get_overlap",
    "get_mismatch",
]
