"""Radiation-reaction fluxes and the inspiral ODE right-hand side (PM path).

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.flux`` for the
Peters-Mathews flux: the conservative sector is the exact Schwarzschild
geodesic (`models.geodesic`), the dissipative sector the orbit-averaged
quadrupole fluxes, and (pdot, edot) follow from the exact 2x2 Jacobian
d(E, L)/d(p, e). The reference takes that Jacobian by ``jax.jacfwd``; here it
is written in closed form, which stays differentiable in forward mode
(`models.integrate` takes a ``torch.func.jvp`` through this RHS).

Units: geometric time per central mass M; fluxes carry one power of nu.
"""

from __future__ import annotations

import torch

from .geodesic import fundamental_frequencies, separatrix


def pn_flux_e_l(p: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orbit-averaged specific energy and angular-momentum fluxes / nu.

      <dE/dt> = -(32/5) p^-5   (1-e^2)^{3/2} (1 + 73/24 e^2 + 37/96 e^4)
      <dL/dt> = -(32/5) p^-7/2 (1-e^2)^{3/2} (1 + 7/8 e^2)
    """
    one_m_e2 = 1.0 - e * e
    fac = one_m_e2 * torch.sqrt(one_m_e2)
    de = -(32.0 / 5.0) * p**-5 * fac * (1.0 + (73.0 / 24.0) * e * e + (37.0 / 96.0) * e**4)
    dl = -(32.0 / 5.0) * p**-3.5 * fac * (1.0 + (7.0 / 8.0) * e * e)
    return de, dl


def _energy_angmom_jacobian(p, e):
    """Closed-form partials (dE/dp, dE/de, dL/dp, dL/de) of `energy_angmom`.

    With N = (p-2)^2 - 4e^2 and D = p - 3 - e^2: E = sqrt(N / (p D)) gives
    dE/dp = E/2 (2(p-2)/N - 1/p - 1/D), dE/de = E/2 (2e/D - 8e/N); L = p /
    sqrt(D) gives dL/dp = (D - p/2) / D^{3/2}, dL/de = p e / D^{3/2}.
    """
    big_n = (p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e)
    big_d = p - 3.0 - e * e
    energy = torch.sqrt(big_n / (p * big_d))
    d32 = big_d * torch.sqrt(big_d)
    de_dp = 0.5 * energy * (2.0 * (p - 2.0) / big_n - 1.0 / p - 1.0 / big_d)
    de_de = 0.5 * energy * (2.0 * e / big_d - 8.0 * e / big_n)
    dl_dp = (big_d - 0.5 * p) / d32
    dl_de = p * e / d32
    return de_dp, de_de, dl_dp, dl_de


def pdot_edot(p: torch.Tensor, e: torch.Tensor, flux_fn=pn_flux_e_l) -> tuple[torch.Tensor, torch.Tensor]:
    """(dp/dt, de/dt) per unit mass ratio, via exact-Jacobian flux balance.

    Solves  [dE/dp dE/de; dL/dp dL/de] [pdot; edot] = [Edot; Ldot].
    """
    de_flux, dl_flux = flux_fn(p, e)
    j00, j01, j10, j11 = _energy_angmom_jacobian(p, e)
    det = j00 * j11 - j01 * j10
    pdot = (j11 * de_flux - j01 * dl_flux) / det
    edot = (-j10 * de_flux + j00 * dl_flux) / det
    return pdot, edot


def inspiral_rhs(state: torch.Tensor, nu: torch.Tensor, flux: str = "pm") -> torch.Tensor:
    """RHS of d/dt [p, e, Phi_phi, Phi_r] in geometric time (units of M).

    ``state``: (B, 4); ``nu``: mass ratio mu/M, (B,) or scalar. ``flux``
    selects the dissipative model; only "pm" (Peters-Mathews) is ported.
    """
    if flux != "pm":
        raise NotImplementedError(
            f"flux={flux!r}: the multipole flux grid is ported with the rwz physics slice"
        )
    p, e = state[..., 0], state[..., 1]
    # clamp eccentricity away from exactly 0 for the edot/e terms
    e_safe = torch.clamp_min(e, 1.0e-9)
    pdot, edot = pdot_edot(p, e_safe)
    omega_phi, omega_r = fundamental_frequencies(p, e_safe)
    return torch.stack([nu * pdot, nu * edot, omega_phi, omega_r], dim=-1)


def stop_condition(state: torch.Tensor, delta_p_stop: float = 0.12) -> torch.Tensor:
    """True where the orbit reaches p <= p_sep + delta_p_stop."""
    return state[..., 0] <= separatrix(state[..., 1]) + delta_p_stop


__all__ = ["pn_flux_e_l", "pdot_edot", "inspiral_rhs", "stop_condition"]
