"""Bound geodesics: energy, angular momentum, frequencies, separatrices.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.geodesic``.
Geometric units with M = 1; orbits parametrized by (p, e) with Darwin
anomaly chi (and, for Kerr, spin a and x = cos I). Periods and advances are
spectrally accurate trapezoid sums of the Darwin (and polar) integrands,
their nodes appended as a last axis, so every function here is elementwise
over any batch shape of its arguments. The Kerr orbit constants come from
fixed-count float64 Newton solves and the Kerr separatrices from fixed-count
bisections, with the reference's iteration and node counts. The Kerr
functions take scalars or tensors and a ``device`` keyword (default a tensor
argument's device, else the current CUDA device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.row_ops import row_sum
from ..utils.device import resolve_device

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
    # fixed-order sums: on the card torch.sum's order follows the batch, and
    # this runs in every dp5 RHS evaluation (ops/row_ops.py)
    t_r = row_sum(dt_dchi) * h
    dphi = row_sum(dphi_dchi) * h
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


# ---------------------------------------------------------------------------
# Equatorial Kerr (x = +-1). The radial potential (Carter constant Q = 0)
#   R(r) = [E(r^2+a^2) - aL]^2 - Delta [r^2 + (L-aE)^2],
#   R(r)/r = c3 r^3 + 2 r^2 + c1 r + c0,
#   c3 = E^2-1, c1 = -[L^2 + a^2(1-E^2)], c0 = 2 (L-aE)^2,
# vanishes at r_p and r_a; (E, L) solve {S(r_p) = 0, [S(r_a) - S(r_p)] /
# (r_a - r_p) = 0}, the divided-difference form that stays regular as
# e -> 0. With the third root r3 = 2(L-aE)^2 / ((1-E^2) r_p r_a),
#   dlambda/dchi = g = sqrt(1-e^2) / [sqrt(1-E^2) (1+e cos chi) sqrt(r (r - r3))],
#   dt/dchi = P_t g, P_t = a(L-aE) + (r^2+a^2) T / Delta,
#   dphi/dchi = P_phi g, P_phi = (L-aE) + a T / Delta, T = E(r^2+a^2) - La,
# and Omega_theta = sqrt(L^2 + a^2(1-E^2)) Lambda_r / T_r. All three reduce
# to the Schwarzschild results at a = 0.
# ---------------------------------------------------------------------------

_N_EL_NEWTON = 40
_N_BISECT = 64


def _f64(*xs, device=None):
    """float64 tensors broadcast together, on ``device`` (`resolve_device`:
    else the first tensor's device, else the current CUDA device)."""
    dev = resolve_device(device, *xs)
    return torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.float64, device=dev) for x in xs))


def _schwarzschild_seed(p, e):
    """Schwarzschild (E, L) of (p, e), the Newton solves' start (exact at a = 0)."""
    denom = torch.clamp_min(p - 3.0 - e * e, 1e-12)
    en = torch.sqrt(
        torch.clamp_min((p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e), 1e-300) / (p * denom))
    return en, p / torch.sqrt(denom)


def kerr_eq_energy_angmom(a, p, e, *, device=None):
    """(E, L) of the bound equatorial Kerr orbit (L signed; a retrograde
    orbit is the prograde one in spin -a, which `fundamental_frequencies_kerr`
    maps for x = -1)."""
    a, p, e = _f64(a, p, e, device=device)
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)  # e < 1 for bound orbits
    en, lz = _schwarzschild_seed(p, e)
    sum_sq = r_a * r_a + r_a * r_p + r_p * r_p
    sum_r = r_a + r_p
    for _ in range(_N_EL_NEWTON):
        x = lz - a * en
        c3 = en * en - 1.0
        c1 = -(lz * lz + a * a * (1.0 - en * en))
        c0 = 2.0 * x * x
        f1 = c3 * r_p**3 + 2.0 * r_p**2 + c1 * r_p + c0
        f2 = c3 * sum_sq + 2.0 * sum_r + c1
        # analytic Jacobian
        d_c3_e = 2.0 * en
        d_c1_e = 2.0 * a * a * en
        d_c0_e = -4.0 * a * x
        d_c1_l = -2.0 * lz
        d_c0_l = 4.0 * x
        j11 = d_c3_e * r_p**3 + d_c1_e * r_p + d_c0_e
        j12 = d_c1_l * r_p + d_c0_l
        j21 = d_c3_e * sum_sq + d_c1_e
        j22 = d_c1_l
        det = j11 * j22 - j12 * j21
        det = torch.where(torch.abs(det) > 1e-300, det, 1e-300)
        en, lz = en - (f1 * j22 - f2 * j12) / det, lz - (j11 * f2 - j21 * f1) / det
    return en, lz


def _kerr_eq_freqs_prograde(a, p, e):
    """(Omega_phi, Omega_theta, Omega_r) of the equatorial orbit; spin a
    signed (negative a = retrograde), orbital angular momentum positive."""
    energy, angmom = kerr_eq_energy_angmom(a, p, e)
    a, p, e, energy, angmom = (
        v[..., None] for v in torch.broadcast_tensors(a, p, e, energy, angmom))
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    x = angmom - a * energy
    one_m_e2 = torch.clamp_min(1.0 - energy * energy, 1e-300)
    r3 = 2.0 * x * x / (one_m_e2 * r_p * r_a)

    ecos = e * torch.cos(_chi(_N_CHI, p))
    r = p / (1.0 + ecos)
    delta = r * r - 2.0 * r + a * a
    big_t = energy * (r * r + a * a) - angmom * a
    g = torch.sqrt(torch.clamp_min(1.0 - e * e, 0.0)) / (
        torch.sqrt(one_m_e2) * (1.0 + ecos) * torch.sqrt(torch.clamp_min(r * (r - r3), 1e-300))
    )
    p_t = a * x + (r * r + a * a) * big_t / delta
    p_phi = x + a * big_t / delta

    h = 2.0 * math.pi / _N_CHI
    t_r = torch.sum(p_t * g, dim=-1) * h
    dphi = torch.sum(p_phi * g, dim=-1) * h
    lam_r = torch.sum(g, dim=-1) * h
    omega_r = 2.0 * math.pi / t_r
    omega_phi = dphi / t_r
    ups_theta = torch.sqrt(angmom * angmom + a * a * one_m_e2)[..., 0]
    return omega_phi, ups_theta * lam_r / t_r, omega_r


def fundamental_frequencies_kerr(a, p, e, x=1.0, *, device=None):
    """(Omega_phi, Omega_theta, Omega_r) for equatorial Kerr (x = +-1).

    ``x = cos(iota)``: +1 prograde, -1 retrograde. A retrograde orbit is the
    prograde one in spin -a with phi -> -phi, so Omega_phi flips sign;
    Omega_theta and Omega_r are positive. At a = 0 these are the
    Schwarzschild results with Omega_theta = Omega_phi.
    """
    a, p, e, x = _f64(a, p, e, x, device=device)
    a_eff = torch.where(x >= 0, a, -a)
    om_phi, om_th, om_r = _kerr_eq_freqs_prograde(a_eff, p, e)
    return torch.where(x >= 0, om_phi, -om_phi), om_th, om_r


def _bisect_separatrix(margin, e):
    """p_s by bisection on a stability margin (positive while the bound
    orbit exists), between 1 + 1e-3 and 12 + 2e."""
    lo = torch.full_like(e, 1.0 + 1e-3)
    hi = 12.0 + 2.0 * e
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        stable = margin(mid) > 0.0
        lo, hi = torch.where(stable, lo, mid), torch.where(stable, mid, hi)
    return 0.5 * (lo + hi)


def separatrix_kerr(a, e, x=1.0, *, device=None):
    """p_s(a, e, x) for equatorial orbits, by bisection on the margin
    r_p - r3 (the periapsis meets the third root of the radial potential at
    the separatrix); a = 0 gives 6 + 2e."""
    a, e, x = _f64(a, e, x, device=device)
    a_eff = torch.where(x >= 0, a, -a)

    def margin(p):
        energy, angmom = kerr_eq_energy_angmom(a_eff, p, e)
        r_p = p / (1.0 + e)
        r_a = p / (1.0 - e + 1e-300)
        xx = angmom - a_eff * energy
        one_m_e2 = 1.0 - energy * energy
        r3 = 2.0 * xx * xx / (one_m_e2 * r_p * r_a)
        ok = torch.isfinite(energy) & (one_m_e2 > 0.0) & (energy > 0.0)
        return torch.where(ok, r_p - r3, -1.0)

    return _bisect_separatrix(margin, e)


# ---------------------------------------------------------------------------
# Generic inclination (x = cos I, z_- = 1 - x^2, sign(L_z) = sign(x)):
#   R(r) = (E(r^2+a^2) - a L_z)^2 - Delta (r^2 + (L_z - a E)^2 + Q)
#        = (1-E^2)(r_a - r)(r - r_p)(r - r3)(r - r4),
#   Theta(z)(1 - z) = beta (z_- - z)(z_+ - z), beta = a^2 (1 - E^2),
#     beta z_+ = beta + L_z^2 / (1 - z_-);
#   dt/dlam = T_r(r) + a^2 E z, T_r = (r^2+a^2)/Delta (E(r^2+a^2) - a L_z)
#     + a L_z - a^2 E;  dphi/dlam = Phi_r(r) + L_z/(1-z), Phi_r = a/Delta
#     (E(r^2+a^2) - a L_z) - a E;
#   Gamma = <T_r>_r + a^2 E <z>_th, Ups_phi = <Phi_r>_r + L_z <1/(1-z)>_th,
#   Omega_i = Ups_i / Gamma. The radial averages use the Darwin angle on
#   [0, pi], the polar ones z = z_- sin^2 psi on [0, pi/2], both
#   endpoint-weighted trapezoids.
# ---------------------------------------------------------------------------


def _kerr_gen_EL(a, p, e, x, n_newton: int = _N_EL_NEWTON):
    """(E, L_z, Q) of the generic bound orbit.

    Newton in (E, L_z) on the residual pair {(R(r_p) + R(r_a))/2,
    (R(r_a) - R(r_p))/(r_a - r_p)}, Q eliminated by the polar turning point
    Q = z_- (beta + L_z^2/(1 - z_-)), seeded from the Schwarzschild (E, L)
    with L_z = x L. The reference takes the residuals' Jacobian by
    ``jax.jacfwd``; here it is written out (R is a polynomial in E, L_z).
    """
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    z_minus = torch.clamp(1.0 - x * x, 0.0, 1.0)
    one_m_zm = torch.clamp_min(1.0 - z_minus, 1e-300)  # = x^2
    span = torch.clamp_min(r_a - r_p, 1e-12)

    def q_of(en, lz):
        return z_minus * (a * a * (1.0 - en * en) + lz * lz / one_m_zm)

    def big_r(r, en, lz, q):
        """R(r) and its partials in E and L_z."""
        delta = r * r - 2.0 * r + a * a
        t = en * (r * r + a * a) - a * lz
        k = lz - a * en
        f = t * t - delta * (r * r + k * k + q)
        dq_de = -2.0 * a * a * z_minus * en
        dq_dl = 2.0 * z_minus * lz / one_m_zm
        df_de = 2.0 * t * (r * r + a * a) - delta * (-2.0 * a * k + dq_de)
        df_dl = -2.0 * a * t - delta * (2.0 * k + dq_dl)
        return f, df_de, df_dl

    en, lz = _schwarzschild_seed(p, e)
    lz = x * lz
    for _ in range(n_newton):
        q = q_of(en, lz)
        f_p, fe_p, fl_p = big_r(r_p, en, lz, q)
        f_a, fe_a, fl_a = big_r(r_a, en, lz, q)
        f0, f1 = 0.5 * (f_p + f_a), (f_a - f_p) / span
        j00, j01 = 0.5 * (fe_p + fe_a), 0.5 * (fl_p + fl_a)
        j10, j11 = (fe_a - fe_p) / span, (fl_a - fl_p) / span
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) > 1e-300, det, 1e-300)
        en, lz = en - (f0 * j11 - f1 * j01) / det, lz - (j00 * f1 - j10 * f0) / det
    return en, lz, q_of(en, lz)


def kerr_gen_constants(a, p, e, x, *, device=None):
    """(E, L_z, Q) for generic (a, p, e, x = cos I), elementwise."""
    return _kerr_gen_EL(*_f64(a, p, e, x, device=device))


def _trapezoid(lo: float, hi: float, n: int, like: torch.Tensor):
    """Nodes and endpoint-weighted trapezoid weights on [lo, hi]."""
    nodes = torch.linspace(lo, hi, n, dtype=like.dtype, device=like.device)
    w = torch.full((n,), (hi - lo) / (n - 1), dtype=like.dtype, device=like.device)
    w[0] = w[-1] = 0.5 * (hi - lo) / (n - 1)
    return nodes, w


def fundamental_frequencies_kerr_generic(a, p, e, x, *, device=None):
    """(Omega_phi, Omega_theta, Omega_r) of the generic bound Kerr geodesic.

    ``x = cos I`` (z_- = 1 - x^2, sign(L_z) = sign(x)); Omega_phi is signed
    by the azimuthal sense, Omega_theta and Omega_r positive. The polar
    average's 257 nodes hold spectral accuracy down to |x| ~ 0.1.
    """
    a, p, e, x = _f64(a, p, e, x, device=device)
    en, lz, q = _kerr_gen_EL(a, p, e, x)
    a, p, e, x, en, lz, q = (v[..., None] for v in (a, p, e, x, en, lz, q))
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    one_m_e2 = torch.clamp_min(1.0 - en * en, 1e-300)
    beta = a * a * one_m_e2
    z_minus = torch.clamp(1.0 - x * x, 0.0, 1.0)
    one_m_zm = torch.clamp_min(1.0 - z_minus, 1e-300)

    # the remaining radial roots by Vieta (r3 >= r4)
    s34 = 2.0 / one_m_e2 - (r_a + r_p)
    p34 = a * a * q / (one_m_e2 * r_a * r_p)
    disc = torch.sqrt(torch.clamp_min(s34 * s34 - 4.0 * p34, 0.0))
    r3 = 0.5 * (s34 + disc)
    r4 = torch.where(r3 > 1e-300, p34 / torch.clamp_min(r3, 1e-300), 0.0)

    # radial averages (Darwin angle)
    chi, wts = _trapezoid(0.0, math.pi, _N_CHI // 2 + 1, p)
    r = p / (1.0 + e * torch.cos(chi))
    g = torch.sqrt(torch.clamp_min(1.0 - e * e, 1e-300)) / (
        (1.0 + e * torch.cos(chi)) * torch.sqrt(one_m_e2)
        * torch.sqrt(torch.clamp_min((r - r3) * (r - r4), 1e-300))
    )
    delta = r * r - 2.0 * r + a * a
    big_t = en * (r * r + a * a) - a * lz
    t_r = (r * r + a * a) / delta * big_t + a * lz - a * a * en
    phi_r = a / delta * big_t - a * en
    lam_r_half = torch.sum(wts * g, dim=-1)  # Lambda_r / 2
    avg_t_r = torch.sum(wts * g * t_r, dim=-1) / lam_r_half
    avg_phi_r = torch.sum(wts * g * phi_r, dim=-1) / lam_r_half

    # polar averages (z = z_- sin^2 psi)
    psi, wth = _trapezoid(0.0, 0.5 * math.pi, 257, p)
    beta_zp = beta + lz * lz / one_m_zm  # exact identity, stable at x -> +-1
    z = z_minus * torch.sin(psi) ** 2
    w_pol = torch.sqrt(torch.clamp_min(beta_zp - beta * z, 1e-300))
    i0 = torch.sum(wth / w_pol, dim=-1)  # Lambda_theta / 4
    avg_z = torch.sum(wth * z / w_pol, dim=-1) / i0
    # L_z <1/(1-z)>: 1 - z >= x^2 > 0 on the orbit; 0 for polar orbits
    one_mz = torch.clamp_min(1.0 - z, 1e-300)
    avg_lz_1mz = torch.where(
        z_minus[..., 0] < 1.0 - 1e-14,
        lz[..., 0] * torch.sum(wth / (one_mz * w_pol), dim=-1) / i0,
        0.0,
    )

    a, en = a[..., 0], en[..., 0]
    gamma = avg_t_r + a * a * en * avg_z
    ups_phi = avg_phi_r + avg_lz_1mz
    return ups_phi / gamma, (0.5 * math.pi / i0) / gamma, (math.pi / lam_r_half) / gamma


def separatrix_kerr_generic(a, e, x, *, device=None):
    """Generic-inclination separatrix p_s(a, e, x), by bisection on the
    periapsis / third-root margin."""
    a, e, x = _f64(a, e, x, device=device)

    def margin(p):
        en, lz, q = _kerr_gen_EL(a, p, e, x)
        r_p = p / (1.0 + e)
        r_a = p / (1.0 - e + 1e-300)
        one_m_e2 = 1.0 - en * en
        s34 = 2.0 / torch.clamp_min(one_m_e2, 1e-300) - (r_a + r_p)
        p34 = a * a * q / (torch.clamp_min(one_m_e2, 1e-300) * r_a * r_p)
        disc = torch.sqrt(torch.clamp_min(s34 * s34 - 4.0 * p34, 0.0))
        r3 = 0.5 * (s34 + disc)
        ok = torch.isfinite(en) & (one_m_e2 > 0.0) & (en > 0.0)
        return torch.where(ok, r_p - r3, -1.0)

    return _bisect_separatrix(margin, e)


__all__ = [
    "separatrix",
    "energy_angmom",
    "fundamental_frequencies",
    "fundamental_frequencies_seconds",
    "darwin_orbit",
    "kerr_eq_energy_angmom",
    "fundamental_frequencies_kerr",
    "separatrix_kerr",
    "kerr_gen_constants",
    "fundamental_frequencies_kerr_generic",
    "separatrix_kerr_generic",
]
