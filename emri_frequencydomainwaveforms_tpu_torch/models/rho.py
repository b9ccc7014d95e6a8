"""Factorized-resummation amplitude corrections: source, rho_lm, delta_lm.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.rho``: the
remaining pieces of the factorized (EOB-style) waveform resummation (Damour,
Iyer & Nagar 2009) on top of the flat-space multipole amplitudes and the
wave-tail factor,

    h_lm = h_lm^(Newtonian, exact geodesic) * S_hat * T_lm
           * rho_lm(x)^l * e^{i delta_lm(x)},

with S_hat the exact-geodesic effective source (E for even-parity modes,
L/sqrt(p) for odd), rho_lm the test-mass PN amplitude series in
x = (M omega_mn / m)^(2/3) and delta_lm the residual phase. The series data
is a copy of the reference's (the CPU parity tests assert equality); see the
JAX module for the provenance and the identities that police it.
"""

from __future__ import annotations

import numpy as np
import torch

_GAMMA_E = 0.5772156649015329
_LN2 = float(np.log(2.0))

# the rho series and the circular source factors are used inside their
# convergence region only (light ring at x = 1/3)
_X_MAX = 0.30

# (l, m) -> rho_lm series at nu = 0: (c1, c2, c3_const, c3_elog,
# c4_const, c4_elog, c5_const, c5_elog); eulerlog_m(x) = gamma_E + ln 2
# + ln m + ln(x)/2 multiplies the *_elog entries. Zeros mean "series not
# carried to that order" (truncation, not a physical zero).
_RHO = {
    (2, 2): (
        -43.0 / 42.0,
        -20555.0 / 10584.0,
        1556919113.0 / 122245200.0, -428.0 / 105.0,
        -387216563023.0 / 160190110080.0, 9202.0 / 2205.0,
        -16094530514677.0 / 533967033600.0, 439877.0 / 55566.0,
    ),
    (2, 1): (
        -59.0 / 56.0,
        -47009.0 / 56448.0,
        7613184941.0 / 2607897600.0, -107.0 / 105.0,
        0.0, 0.0, 0.0, 0.0,
    ),
    (3, 3): (
        -7.0 / 6.0,
        -6719.0 / 3960.0,
        3203101567.0 / 227026800.0, -26.0 / 7.0,
        0.0, 0.0, 0.0, 0.0,
    ),
    (3, 1): (
        -13.0 / 18.0,
        101.0 / 7128.0,
        11706720301.0 / 6129723600.0, -26.0 / 63.0,
        0.0, 0.0, 0.0, 0.0,
    ),
    (3, 2): (-164.0 / 135.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (4, 4): (-269.0 / 220.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (4, 2): (-191.0 / 220.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (4, 3): (-111.0 / 88.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (4, 1): (-301.0 / 264.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (5, 5): (-487.0 / 390.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
}

# (l, m) -> delta_lm leading coefficients at nu = 0: (d32 * x^{3/2},
# d3 * pi * x^3).
_DELTA = {
    (2, 2): (7.0 / 3.0, 428.0 / 105.0),
    (2, 1): (2.0 / 3.0, 107.0 / 105.0),
    (3, 3): (13.0 / 10.0, 26.0 / 7.0),
    (3, 1): (13.0 / 30.0, 26.0 / 63.0),
    (4, 4): (14.0 / 15.0, 0.0),
    (4, 2): (7.0 / 15.0, 0.0),
}


def source_factors(p: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(S_even, S_odd) exact-geodesic effective sources, shape of ``p``.

    S_even = E(p, e) = sqrt((p-2-2e)(p-2+2e) / (p (p-3-e^2)))  -> E_circ
    S_odd  = L(p, e)/sqrt(p) = 1/sqrt(1 - (3+e^2)/p)           -> 1/sqrt(1-3u)

    Both -> 1 as p -> inf. Valid above the separatrix p > 6 + 2e.
    """
    pm2 = p - 2.0
    denom = torch.clamp_min(p - 3.0 - e * e, 1e-12)
    s_even = torch.sqrt(torch.clamp_min(pm2 * pm2 - 4.0 * e * e, 0.0) / (p * denom))
    s_odd = torch.sqrt(p / denom)
    return s_even, s_odd


def _x_of_mode(omega_mn: torch.Tensor, ms) -> torch.Tensor:
    """Circular-equivalent PN parameter x = (|omega|/max(m,1))^(2/3), clamped."""
    m_safe = np.maximum(np.abs(np.asarray(ms)), 1).astype(np.float64)
    ratio = torch.abs(omega_mn) / torch.as_tensor(m_safe, device=omega_mn.device)
    return torch.clamp_max(ratio ** (2.0 / 3.0), _X_MAX)


def rho_l_pow(ls, ms, x: torch.Tensor) -> torch.Tensor:
    """rho_lm(x)^l per mode; modes without tabulated series return 1.

    ``ls``/``ms``: static per-mode integers, broadcast on the last axis of
    ``x``.
    """
    dev = x.device
    n_modes = len(ls)
    coeffs = np.zeros((n_modes, 8))
    for i, (l, m) in enumerate(zip(ls, ms)):
        coeffs[i] = _RHO.get((int(l), int(abs(m))), (0.0,) * 8)
    c = torch.as_tensor(coeffs, device=dev)  # (M, 8)

    m_safe = np.maximum(np.abs(np.asarray(ms)), 1).astype(np.float64)
    elog_const = torch.as_tensor(_GAMMA_E + _LN2 + np.log(m_safe), device=dev)
    elog = elog_const + 0.5 * torch.log(torch.clamp_min(x, 1e-30))

    c3 = c[..., 2] + c[..., 3] * elog
    c4 = c[..., 4] + c[..., 5] * elog
    c5 = c[..., 6] + c[..., 7] * elog
    rho = 1.0 + x * (c[..., 0] + x * (c[..., 1] + x * (c3 + x * (c4 + x * c5))))

    r2 = rho * rho
    r3 = r2 * rho
    r4 = r2 * r2
    ls_t = torch.as_tensor(np.asarray(ls), device=dev)
    out = r4 * r4
    for l, val in ((7, r4 * r3), (6, r4 * r2), (5, r4 * rho), (4, r4), (3, r3), (2, r2)):
        out = torch.where(ls_t == l, val, out)
    return out


def delta_lm(ls, ms, x: torch.Tensor) -> torch.Tensor:
    """Residual phase delta_lm(x) per mode (0 where not tabulated)."""
    n_modes = len(ls)
    d = np.zeros((n_modes, 2))
    for i, (l, m) in enumerate(zip(ls, ms)):
        d[i] = _DELTA.get((int(l), int(abs(m))), (0.0, 0.0))
    dj = torch.as_tensor(d, device=x.device)
    x32 = x * torch.sqrt(x)
    return dj[..., 0] * x32 + (np.pi * dj[..., 1]) * (x32 * x32)


def factorized_correction(
    table_ls,
    table_ms,
    p: torch.Tensor,
    e: torch.Tensor,
    omega_mn: torch.Tensor,
    *,
    include_delta: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex multiplier S_hat * rho^l * e^{i delta} per (..., mode).

    ``p``/``e``: orbit parameters (the leading axes of ``omega_mn``);
    ``omega_mn``: per-mode frequencies M omega (any sign: rho and delta are
    even in omega, and delta flips sign with the frequency branch as the
    tail phase does).
    """
    x = _x_of_mode(omega_mn, table_ms)
    s_even, s_odd = source_factors(p, e)
    parity_even = (np.asarray(table_ls) + np.abs(np.asarray(table_ms))) % 2 == 0
    src = torch.where(
        torch.as_tensor(parity_even, device=omega_mn.device), s_even[..., None], s_odd[..., None]
    )
    mag = src * rho_l_pow(table_ls, table_ms, x)
    if not include_delta:
        return mag, torch.zeros_like(mag)
    dl = delta_lm(table_ls, table_ms, x) * torch.sign(omega_mn)
    return mag * torch.cos(dl), mag * torch.sin(dl)


__all__ = ["source_factors", "rho_l_pow", "delta_lm", "factorized_correction"]
