"""Radiation-reaction fluxes and the inspiral ODE right-hand side.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.flux``: the
conservative sector is the exact Schwarzschild geodesic (`models.geodesic`);
the dissipative sector is either the orbit-averaged Peters-Mathews
quadrupole flux (`pn_flux_e_l`) or the multipole flux, the energy the
waveform's own mode amplitudes carry (`flux_from_modes`), tabulated once on a
regular (u, e) grid (`build_flux_grid`) and interpolated bicubically inside
the trajectory loop (`multipole_flux_e_l`). (pdot, edot) follow from the
exact 2x2 Jacobian d(E, L)/d(p, e). The reference takes that Jacobian by
``jax.jacfwd``; here it is written in closed form, which stays
differentiable in forward mode (`models.integrate` takes a
``torch.func.jvp`` through this RHS).

Units: geometric time per central mass M; fluxes carry one power of nu.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp2d import interp2d_bicubic, interp2d_bicubic_dense
from ..utils.device import resolve_device
from .amplitude import ModeTable, default_mode_table, mode_amplitudes
from .amplitude_backends import _U_SHIFT, u_of_pe
from .geodesic import fundamental_frequencies, separatrix
from .rho import _x_of_mode, factorized_correction
from .rwz_calibration import rwz_correction, rwz_ecc_residual
from .tail import tail_modulus_sq


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


def flux_from_modes(
    p: torch.Tensor, e: torch.Tensor, table: ModeTable | None = None,
    *, tail: bool = False, factorized: bool = False, rwz: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Edot, Ldot)/nu from the waveform's own multipole content.

    Energy balance with the table's mode amplitudes: each (l, m, n) harmonic
    radiates dE/dt = (1/16 pi) omega^2 |A|^2 and carries L_z/E = m/omega, so

      <dE/dt>/nu = -(1/8 pi) sum_table omega_mn^2 |A_lmn|^2
      <dL/dt>/nu = -(1/8 pi) sum_table m omega_mn |A_lmn|^2

    (factor 2 from the tabulated m >= 0 half plus equatorial partners).
    ``tail`` weighs each harmonic by |T_lm|^2, ``factorized`` by
    (S_hat rho_lm^l)^2 and ``rwz`` by |B_lm R_lmn|^2, keeping the dissipation
    energy-balanced with the amplitudes at the same rung.
    """
    if rwz and not (tail and factorized):
        raise ValueError("rwz=True requires tail=True, factorized=True")
    if table is None:
        table = default_mode_table(30)
    dev = p.device
    a_re, a_im = mode_amplitudes(p, e, table)
    om_phi, om_r = fundamental_frequencies(p, e)
    m_f = torch.as_tensor(table.ms.astype(np.float64), device=dev)
    n_f = torch.as_tensor(table.ns.astype(np.float64), device=dev)
    om = m_f * om_phi[..., None] + n_f * om_r[..., None]
    power = a_re * a_re + a_im * a_im
    if tail:
        power = power * tail_modulus_sq(table.ls, om)
    if factorized:
        s_rho, _ = factorized_correction(table.ls, table.ms, p, e, om, include_delta=False)
        power = power * (s_rho * s_rho)
    if rwz:
        b = rwz_correction(table.ls, table.ms, _x_of_mode(om, table.ms))
        r_re, r_im = rwz_ecc_residual(table.ls, table.ms, table.ns, u_of_pe(p, e), e)
        # the phase residual cancels in the power
        power = power * (b * b) * (r_re * r_re + r_im * r_im)
    inv8pi = 1.0 / (8.0 * math.pi)
    de = -inv8pi * torch.sum(om * om * power, dim=-1)
    dl = -inv8pi * torch.sum(m_f * om * power, dim=-1)
    return de, dl


# grid points per `flux_from_modes` call of a grid build: the orbit-harmonic
# projection of the full l <= 6 table keeps ~0.5 MB of temporaries per point
_GRID_CHUNK = 512


class FluxGrid(NamedTuple):
    """Regular (u, e) table of (Edot, Ldot)/nu for the trajectory RHS."""

    u0: float
    du: float
    e0: float
    de: float
    values: torch.Tensor  # (nu, ne, 2) float64: Edot, Ldot


def build_flux_grid(
    u_range=None, e_range=(1e-6, 0.78), n_u: int = 96, n_e: int = 49,
    tail: bool = False, factorized: bool = False, rwz: bool = False,
    device=None,
) -> FluxGrid:
    """Tabulate `flux_from_modes` on the (u, e) grid, on ``device``.

    The points are evaluated `_GRID_CHUNK` at a time. ``device`` as for
    every entry point (`resolve_device`).
    """
    dev = resolve_device(device)
    if u_range is None:
        u_range = (np.log(_U_SHIFT + 0.02), np.log(16.0))
    us = np.linspace(u_range[0], u_range[1], n_u)
    es = np.linspace(e_range[0], e_range[1], n_e)
    uu, ee = np.meshgrid(us, es, indexing="ij")
    pp = np.exp(uu) - _U_SHIFT + 6.0 + 2.0 * ee
    p_all = torch.as_tensor(pp.ravel(), dtype=torch.float64, device=dev)
    e_all = torch.as_tensor(ee.ravel(), dtype=torch.float64, device=dev)
    parts = [
        torch.stack(flux_from_modes(p_c, e_c, tail=tail, factorized=factorized, rwz=rwz), dim=-1)
        for p_c, e_c in zip(p_all.split(_GRID_CHUNK), e_all.split(_GRID_CHUNK))
    ]
    return FluxGrid(
        u0=float(us[0]), du=float(us[1] - us[0]),
        e0=float(es[0]), de=float(es[1] - es[0]),
        values=torch.cat(parts).reshape(n_u, n_e, 2),
    )


_DEFAULT_GRIDS: dict = {}


def default_flux_grid(
    tail: bool = False, factorized: bool = False, rwz: bool = False, device=None
) -> FluxGrid:
    """The production (96, 49) grid at the given rung, built once per
    (rung, device) and kept for the life of the process."""
    dev = resolve_device(device)
    key = (bool(tail), bool(factorized), bool(rwz), str(dev))
    if key not in _DEFAULT_GRIDS:
        _DEFAULT_GRIDS[key] = build_flux_grid(
            tail=tail, factorized=factorized, rwz=rwz, device=dev
        )
    return _DEFAULT_GRIDS[key]


def multipole_flux_e_l(p: torch.Tensor, e: torch.Tensor, grid: FluxGrid | None = None,
                       dense: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(Edot, Ldot)/nu by bicubic interpolation of the multipole-flux grid
    (default: the flat-rung `default_flux_grid` on ``p``'s device).

    ``dense=False`` gathers the 4x4 stencil; ``dense=True`` evaluates the
    same Catmull-Rom surface as dense cardinal contractions
    (`ops.interp2d.interp2d_bicubic_dense`), equal up to reduction order.
    """
    if grid is None:
        grid = default_flux_grid(device=p.device)
    fn = interp2d_bicubic_dense if dense else interp2d_bicubic
    out = fn(grid.u0, grid.du, grid.e0, grid.de, grid.values, u_of_pe(p, e), e)
    return out[..., 0], out[..., 1]


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


def as_flux_fn(flux_fn):
    """A dissipative model as a function ``(p, e) -> (Edot, Ldot)/nu``: a
    `FluxGrid` becomes its `multipole_flux_e_l` interpolant, a function is
    returned as it is."""
    if isinstance(flux_fn, FluxGrid):
        grid = flux_fn
        return lambda p_, e_: multipole_flux_e_l(p_, e_, grid)
    return flux_fn


class InspiralRHS(NamedTuple):
    """Parameters of the inspiral ODE."""

    nu: torch.Tensor  # mass ratio mu/M, (B,) or scalar


def inspiral_rhs(state: torch.Tensor, nu, flux_fn=pn_flux_e_l) -> torch.Tensor:
    """RHS of d/dt [p, e, Phi_phi, Phi_r] in geometric time (units of M).

    ``state``: (B, 4); ``nu``: mass ratio mu/M, (B,) or scalar, bare or in
    an `InspiralRHS`. ``flux_fn`` is the dissipative model: `pn_flux_e_l`
    (Peters-Mathews), a function ``(p, e) -> (Edot, Ldot)/nu``, or a
    `FluxGrid` to interpolate with `multipole_flux_e_l`.
    """
    if isinstance(nu, InspiralRHS):
        nu = nu.nu
    flux_fn = as_flux_fn(flux_fn)
    p, e = state[..., 0], state[..., 1]
    # clamp eccentricity away from exactly 0 for the edot/e terms
    e_safe = torch.clamp_min(e, 1.0e-9)
    pdot, edot = pdot_edot(p, e_safe, flux_fn)
    omega_phi, omega_r = fundamental_frequencies(p, e_safe)
    return torch.stack([nu * pdot, nu * edot, omega_phi, omega_r], dim=-1)


def stop_condition(state: torch.Tensor, delta_p_stop: float = 0.12) -> torch.Tensor:
    """True where the orbit reaches p <= p_sep + delta_p_stop."""
    return state[..., 0] <= separatrix(state[..., 1]) + delta_p_stop


__all__ = [
    "pn_flux_e_l",
    "flux_from_modes",
    "FluxGrid",
    "build_flux_grid",
    "default_flux_grid",
    "multipole_flux_e_l",
    "pdot_edot",
    "as_flux_fn",
    "InspiralRHS",
    "inspiral_rhs",
    "stop_condition",
]
