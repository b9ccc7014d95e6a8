"""Quadrature inspiral trajectory, batched over walkers: p as the clock.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.trajectory_quad``
(``method="quad"`` of `inspiral.schwarz_ecc_flux_inspiral`). The semi-latus
rectum p decreases monotonically along an inspiral, so it serves as the
independent variable:

  * de/dp = edot/pdot is free of the mass ratio and smooth up to the
    separatrix; a fixed 96-step RK4 integrates it on a uniform p-grid;
  * dt/dp = 1/(nu pdot) and dPhi/dp = Omega/(nu pdot) are then explicit
    functions of p, so t(p) and both phases are cumulative integrals of
    not-a-knot splines through the integrands, evaluated for all knots at
    once;
  * when the plunge lies beyond the horizon, a fixed 40-step bisection on
    the monotone t(p) finds p(t_max) and the knots are rebuilt on
    [p0, p(t_max)].

Every loop has a fixed count and every branch is a per-lane ``torch.where``,
so the whole trajectory is issued without one host synchronization: the
walker batch's cost is a fixed number of small launches, whatever the data.
The reference is a single-lane ``jit`` that its tests ``vmap``; here every
input is (B,) and every field (B, max_steps). Knots are uniform in p, which
clusters them in t near the plunge, where the phase curvature peaks.
"""

from __future__ import annotations

import torch

from ..ops.cubic_spline import fit_cubic_spline, spline_eval
from ..utils.constants import MTSUN_SI, YRSID_SI
from .flux import as_flux_fn, pdot_edot
from .geodesic import fundamental_frequencies
from .inspiral import Trajectory, _batch_f64, flux_model

_P_FLOOR = 6.04  # below every possible stop p_sep(e) + delta (e >= 0)
_N_BISECT = 40


def _clamp_domain(p, e):
    """Keep flux and frequency evaluations above the separatrix: RK stages
    and spline overshoot can probe p < p_sep, where the Jacobian
    determinant crosses zero; the knots kept all lie above p_sep + delta."""
    e_safe = torch.clamp(e, 1.0e-9, 0.999)
    p_safe = torch.maximum(p, 6.0 + 2.0 * e_safe + 0.02)
    return p_safe, e_safe


def _de_dp(p, e, flux_fn):
    p_safe, e_safe = _clamp_domain(p, e)
    pdot, edot = pdot_edot(p_safe, e_safe, flux_fn)
    return edot / pdot


def _integrands(p, e, flux_fn):
    """(dt/dp, dPhi_phi/dp, dPhi_r/dp) per unit mass ratio, elementwise over
    any shape of knots (all negative: p falls while t and the phases rise)."""
    p_safe, e_safe = _clamp_domain(p, e)
    pdot, _ = pdot_edot(p_safe, e_safe, flux_fn)
    om_phi, om_r = fundamental_frequencies(p_safe, e_safe)
    inv = 1.0 / pdot
    return inv, om_phi * inv, om_r * inv


def _cumulative_spline_integral(x, ys):
    """Cumulative integrals of each row of ``ys`` (B, R, n) sampled at the
    strictly increasing knots ``x`` (B, n): a not-a-knot cubic through the
    samples, integrated segment by segment in closed form. Returns an array
    like ``ys`` with [..., 0] = 0."""
    h = torch.diff(x, dim=-1)[:, None, :]
    c = fit_cubic_spline(x[:, None, :], ys, bc="not-a-knot").c
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    # integral of c0 + c1 u + c2 u^2 + c3 u^3 over u in [0, h]
    seg = h * (c0 + h * (c1 / 2.0 + h * (c2 / 3.0 + h * c3 / 4.0)))
    return torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)


def _solve_e_of_p(p0, e0, flux_fn, n_seq: int):
    """Fixed-step RK4 of de/dp from p0 down to ``_P_FLOOR``, per lane.

    Returns (p_grid, e_grid), each (B, n_seq + 1), p descending. A lane's
    steps freeze once inside the unstable region (p < p_sep + small): the
    flux Jacobian changes sign there, and frozen values are never used.
    """
    h = (_P_FLOOR - p0) / n_seq  # (B,), negative
    p, e = p0, e0
    e_hist = [e0]
    for _ in range(n_seq):
        k1 = _de_dp(p, e, flux_fn)
        k2 = _de_dp(p + 0.5 * h, e + 0.5 * h * k1, flux_fn)
        k3 = _de_dp(p + 0.5 * h, e + 0.5 * h * k2, flux_fn)
        k4 = _de_dp(p + h, e + h * k3, flux_fn)
        de = (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        unstable = p + h <= 6.0 + 2.0 * e
        e = torch.where(unstable, e, torch.clamp(e + de, 0.0, 0.999))
        p = p + h
        e_hist.append(e)
    steps = torch.arange(n_seq + 1, dtype=p0.dtype, device=p0.device)
    return p0[:, None] + h[:, None] * steps, torch.stack(e_hist, dim=-1)


def _find_stop(p_grid, e_grid, delta_p_stop):
    """Per lane, the interpolated root of phi(p) = p - (6 + 2 e(p) + delta)
    (the stop surface) along the descending grid; a lane that never crosses
    stops at the grid's last point."""
    phi = p_grid - (6.0 + 2.0 * e_grid + delta_p_stop)
    crossed = phi <= 0.0
    # first crossed index (argmax returns the first maximum; bool is cast)
    idx = torch.argmax(crossed.to(torch.int32), dim=-1)
    idx = torch.clamp(idx, 1, p_grid.shape[-1] - 1)[:, None]
    ph_a, ph_b = phi.gather(-1, idx - 1)[:, 0], phi.gather(-1, idx)[:, 0]
    p_a, p_b = p_grid.gather(-1, idx - 1)[:, 0], p_grid.gather(-1, idx)[:, 0]
    w = ph_a / torch.clamp_min(ph_a - ph_b, 1e-300)
    p_stop = p_a + w * (p_b - p_a)
    return torch.where(crossed.any(dim=-1), p_stop, p_grid[:, -1])


def schwarz_ecc_flux_inspiral_quad(
    mass_1,
    mass_2,
    p0,
    e0,
    *,
    t_years: float = 1.0,
    Phi_phi0=0.0,
    Phi_r0=0.0,
    max_steps: int = 192,
    n_seq: int = 96,
    delta_p_stop: float = 0.12,
    flux: str = "pm",
    flux_grid=None,
    device=None,
) -> Trajectory:
    """Quadrature counterpart of `inspiral.schwarz_ecc_flux_inspiral`.

    Arguments as there (``flux``, ``flux_grid`` and ``device`` included).
    Returns the same `Trajectory` of (B, max_steps) fields with every knot
    live (``n == max_steps``) and each lane's last knot at min(plunge,
    t_max).
    """
    m, mu, p0, e0, ph0, pr0 = _batch_f64(mass_1, mass_2, p0, e0, Phi_phi0, Phi_r0, device=device)
    flux_fn = as_flux_fn(flux_model(flux, p0.device, flux_grid))
    nu = mu / m
    t_max_geo = t_years * YRSID_SI / (m * MTSUN_SI)

    # the sequential part: e(p) on the coarse grid
    p_seq, e_seq = _solve_e_of_p(p0, e0, flux_fn, n_seq)
    p_stop = _find_stop(p_seq, e_seq, delta_p_stop)
    e_sp = fit_cubic_spline(p_seq.flip(-1), e_seq.flip(-1), bc="not-a-knot")
    frac = torch.arange(max_steps, dtype=p0.dtype, device=p0.device) / (max_steps - 1)

    def build(p_end):
        """Knots uniform in p on [p0, p_end] and the integrals over them."""
        p_k = p0[:, None] + (p_end - p0)[:, None] * frac  # descending
        e_k = torch.clamp(spline_eval(e_sp, p_k), 0.0, 0.999)
        f_t, f_phi, f_r = _integrands(p_k, e_k, flux_fn)
        ints = _cumulative_spline_integral(
            p_k.flip(-1), torch.stack([f_t.flip(-1), f_phi.flip(-1), f_r.flip(-1)], dim=1)
        )
        # F(x_j) = int_{p_end}^{x_j} f dx (ascending); the integrands are
        # negative, so t(p) = F(p) - F(p0) >= 0, reversed back to the
        # descending knot order (increasing time)
        rel = (ints - ints[..., -1:]).flip(-1) / nu[:, None, None]
        return p_k, e_k, rel[:, 0], rel[:, 1], rel[:, 2]

    # pass 1: the plunge-bounded grid
    p_k, _, t_geo, _, _ = build(p_stop)
    t_end = t_geo[:, -1]

    # pass 2: where the horizon comes before the plunge, bisect the
    # monotone t(p) for p(t_max). Every lane bisects and each keeps its own
    # branch, as the reference's lax.cond does under vmap; t(p) is one
    # spline, fitted once.
    t_sp = fit_cubic_spline(p_k.flip(-1), t_geo.flip(-1), bc="not-a-knot")
    lo, hi = p_stop, p0  # t(lo) = t_end >= t_max > 0 = t(hi)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        too_late = spline_eval(t_sp, mid[:, None])[:, 0] >= t_max_geo
        lo, hi = torch.where(too_late, mid, lo), torch.where(too_late, hi, mid)
    p_cut = torch.where(t_end > t_max_geo, 0.5 * (lo + hi), p_stop)
    p_k, e_k, t_geo, phi_phi, phi_r = build(p_cut)

    t_sec = t_geo * (m * MTSUN_SI)[:, None]
    return Trajectory(
        t=t_sec,
        p=p_k,
        e=e_k,
        x=torch.ones_like(t_sec),
        Phi_phi=phi_phi + ph0[:, None],
        Phi_theta=torch.zeros_like(t_sec),
        Phi_r=phi_r + pr0[:, None],
        n=torch.full_like(p0, max_steps, dtype=torch.int32),
    )


__all__ = ["schwarz_ecc_flux_inspiral_quad"]
