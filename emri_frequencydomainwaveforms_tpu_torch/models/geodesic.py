"""Schwarzschild eccentric geodesics: energy, angular momentum, frequencies.

Counterpart of the Schwarzschild part of
``emri_frequencydomainwaveforms_tpu.models.geodesic``. Geometric units with
M = 1; orbits parametrized by (p, e) with Darwin anomaly chi. Radial period
and periapsis advance are spectrally accurate periodic-trapezoid sums of the
Darwin integrands over ``_N_CHI`` nodes, appended as a last axis, so every
function here is elementwise over any batch shape of (p, e).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# quadrature resolution of the periodic Darwin integrands (see the JAX module)
_N_CHI = 256


def separatrix(e: torch.Tensor) -> torch.Tensor:
    """Schwarzschild separatrix p_s(e) = 6 + 2e."""
    return 6.0 + 2.0 * e


def energy_angmom(p: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Specific orbital energy E and angular momentum L of the geodesic.

    E^2 = ((p-2)^2 - 4 e^2) / (p (p - 3 - e^2)),  L^2 = p^2 / (p - 3 - e^2).
    """
    denom = p - 3.0 - e * e
    energy = torch.sqrt(((p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e)) / (p * denom))
    angmom = p / torch.sqrt(denom)
    return energy, angmom


def _chi(n_chi: int, like: torch.Tensor) -> torch.Tensor:
    return (2.0 * math.pi / n_chi) * torch.arange(n_chi, dtype=like.dtype, device=like.device)


def _darwin_integrands(p, e, chi):
    """(dphi/dchi, dt/dchi) on the chi grid, shape ``p.shape + (n_chi,)``."""
    p = p[..., None]
    e = e[..., None]
    ecos = e * torch.cos(chi)
    rad = p - 6.0 - 2.0 * ecos  # > 0 above the separatrix
    dphi_dchi = torch.sqrt(p / rad)
    dt_dchi = (
        p
        * p
        * torch.sqrt((p - 2.0) ** 2 - 4.0 * e * e)
        / ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * torch.sqrt(rad))
    )
    return dphi_dchi, dt_dchi


def fundamental_frequencies(p: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dimensionless (Omega_phi, Omega_r) of the bound eccentric orbit.

    T_r = int_0^{2pi} dt/dchi, Dphi = int_0^{2pi} dphi/dchi (periodic
    trapezoid); Omega_r = 2 pi / T_r, Omega_phi = Dphi / T_r.
    """
    p, e = torch.broadcast_tensors(p, e)
    dphi_dchi, dt_dchi = _darwin_integrands(p, e, _chi(_N_CHI, p))
    h = 2.0 * math.pi / _N_CHI
    t_r = torch.sum(dt_dchi, dim=-1) * h
    dphi = torch.sum(dphi_dchi, dim=-1) * h
    return dphi / t_r, 2.0 * math.pi / t_r


def fundamental_frequencies_seconds(
    p: torch.Tensor, e: torch.Tensor, mass_sun
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Omega_phi, Omega_r) in rad/s for a central mass in solar masses."""
    from ..utils.constants import MTSUN_SI

    omega_phi, omega_r = fundamental_frequencies(p, e)
    scale = 1.0 / (mass_sun * MTSUN_SI)
    return omega_phi * scale, omega_r * scale


_ANTIDERIV_CACHE: dict[int, np.ndarray] = {}


def _antiderivative_matrix(n: int) -> np.ndarray:
    """Real (n, n) matrix A with (A g)_i = antiderivative of zero-mean
    periodic g at chi_i, vanishing at chi_0 = 0 (numpy FFT of the identity;
    cached per resolution)."""
    if n not in _ANTIDERIV_CACHE:
        eye = np.eye(n)
        gk = np.fft.rfft(eye, axis=0)
        k = np.arange(gk.shape[0])
        scale = np.zeros_like(k, dtype=np.complex128)
        scale[1:] = 1.0 / (1j * k[1:])
        gint = np.fft.irfft(gk * scale[:, None], n=n, axis=0)
        gint = gint - gint[0:1, :]
        _ANTIDERIV_CACHE[n] = gint
    return _ANTIDERIV_CACHE[n]


def darwin_orbit(p: torch.Tensor, e: torch.Tensor, n_chi: int = _N_CHI) -> dict:
    """One radial period of the bound geodesic, sampled uniformly in chi.

    Returns a dict with chi ``(n_chi,)``, and r, t, phi of shape
    ``p.shape + (n_chi,)`` (t and phi from periapsis, zero at chi = 0), plus
    the period T_r and advance Dphi of shape ``p.shape``.
    """
    p, e = torch.broadcast_tensors(p, e)
    chi = _chi(n_chi, p)
    dphi_dchi, dt_dchi = _darwin_integrands(p, e, chi)
    r = p[..., None] / (1.0 + e[..., None] * torch.cos(chi))
    a_op = torch.as_tensor(_antiderivative_matrix(n_chi), dtype=p.dtype, device=p.device)

    def periodic_antiderivative(g):
        mean = torch.mean(g, dim=-1, keepdim=True)
        return (g - mean) @ a_op.T + mean * chi

    h = 2.0 * math.pi / n_chi
    return {
        "chi": chi,
        "r": r,
        "t": periodic_antiderivative(dt_dchi),
        "phi": periodic_antiderivative(dphi_dchi),
        "T_r": torch.sum(dt_dchi, dim=-1) * h,
        "Dphi": torch.sum(dphi_dchi, dim=-1) * h,
    }


__all__ = [
    "separatrix",
    "energy_angmom",
    "fundamental_frequencies",
    "fundamental_frequencies_seconds",
    "darwin_orbit",
]
