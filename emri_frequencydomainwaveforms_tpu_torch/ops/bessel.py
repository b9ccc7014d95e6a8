"""Bessel functions: the scaled ``K_{1/3}`` of the SPA correction, and J_n.

Counterpart of ``emri_frequencydomainwaveforms_tpu.ops.bessel``.
``K_{1/3}(z) e^z`` comes from the ascending series through ``I_{+-1/3}``
for ``|z| < 8`` and the Poincare asymptotic series above, on the principal
branch: `kve_one_third` for complex ``z``, `kve_one_third_imag` for
``z = i w`` in real arithmetic and in the dtype of ``w`` (float32 on the FD
level-1 path, as in the reference). `bessel_jn` is J_0..J_n by Miller's
backward recurrence (the Peters-Mathews checks use it).
"""

from __future__ import annotations

import math

import torch

from ..utils.device import resolve_device

_NU = 1.0 / 3.0
_SERIES_TERMS = 30
_ASYMP_TERMS = 12
_SWITCH = 8.0

# 1 / Gamma(k + 1 +- nu) / k!
_INV_GAMMA_P = [1.0 / (math.gamma(k + 1.0 + _NU) * math.factorial(k)) for k in range(_SERIES_TERMS)]
_INV_GAMMA_M = [1.0 / (math.gamma(k + 1.0 - _NU) * math.factorial(k)) for k in range(_SERIES_TERMS)]

# asymptotic coefficients a_k(nu): a_0 = 1, a_k = a_{k-1} (4 nu^2 - (2k-1)^2) / (8 k)
_ASYMP_COEF = [1.0]
for _k in range(1, _ASYMP_TERMS):
    _ASYMP_COEF.append(_ASYMP_COEF[-1] * (4.0 * _NU**2 - (2.0 * _k - 1.0) ** 2) / (8.0 * _k))


def _kve_small(z: torch.Tensor) -> torch.Tensor:
    """K_{1/3}(z) e^z by the ascending series (accurate for |z| <~ 6)."""
    q = 0.25 * z * z  # (z/2)^2
    s_p = torch.full_like(z, _INV_GAMMA_P[-1])
    s_m = torch.full_like(z, _INV_GAMMA_M[-1])
    for k in range(_SERIES_TERMS - 2, -1, -1):
        s_p = s_p * q + _INV_GAMMA_P[k]
        s_m = s_m * q + _INV_GAMMA_M[k]
    half_z_nu = torch.exp(_NU * torch.log(0.5 * z))  # principal branch
    i_p = half_z_nu * s_p
    i_m = s_m / half_z_nu
    k_nu = (math.pi / 2.0) / math.sin(_NU * math.pi) * (i_m - i_p)
    return k_nu * torch.exp(z)


def _kve_large(z: torch.Tensor) -> torch.Tensor:
    """K_{1/3}(z) e^z by the Poincare asymptotic expansion (|z| >~ 4)."""
    inv_z = 1.0 / z
    s = torch.full_like(z, _ASYMP_COEF[-1])
    for k in range(_ASYMP_TERMS - 2, -1, -1):
        s = s * inv_z + _ASYMP_COEF[k]
    return torch.sqrt(math.pi / 2.0 * inv_z) * s


def kve_one_third(z, device=None) -> torch.Tensor:
    """``K_{1/3}(z) * exp(z)`` for complex ``z`` on the principal branch
    (``scipy.special.kv(1/3, z) * exp(z)``), on ``device``, else ``z``'s
    device, else the current CUDA device. A tensor gives complex128 for
    float64 or complex128, else complex64; other input gives complex128."""
    dev = resolve_device(device, z)
    if isinstance(z, torch.Tensor):
        wide = z.dtype in (torch.complex128, torch.float64)
        z = z.to(dev, torch.complex128 if wide else torch.complex64)
    else:
        z = torch.as_tensor(z, dtype=torch.complex128, device=dev)
    small = torch.abs(z) < _SWITCH
    # each branch gets a safe argument where it is not selected
    switch = torch.full_like(z, _SWITCH)
    z_small = torch.where(small, z, switch)
    z_large = torch.where(small, switch, z)
    return torch.where(small, _kve_small(z_small), _kve_large(z_large))


def kve_one_third_imag(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``K_{1/3}(i w) * exp(i w)`` for real ``w`` -> ``(re, im)`` like ``w``."""
    aw = torch.abs(w)
    sgn = torch.sign(w)
    small = aw < _SWITCH
    aw_small = torch.where(small, aw, torch.full_like(aw, _SWITCH))
    aw_large = torch.where(small, torch.full_like(aw, _SWITCH), aw)

    # small branch: ascending series in q = -w^2/4 (real)
    q = -0.25 * aw_small * aw_small
    s_p = torch.full_like(q, _INV_GAMMA_P[-1])
    s_m = torch.full_like(q, _INV_GAMMA_M[-1])
    for k in range(_SERIES_TERMS - 2, -1, -1):
        s_p = s_p * q + _INV_GAMMA_P[k]
        s_m = s_m * q + _INV_GAMMA_M[k]
    # (z/2)^nu = (|w|/2)^nu e^{i pi nu/2 sgn}
    r_nu = torch.exp(_NU * torch.log(0.5 * aw_small))
    c_nu, s_nu = math.cos(math.pi * _NU / 2.0), math.sin(math.pi * _NU / 2.0)
    ip_re = r_nu * c_nu * s_p
    ip_im = r_nu * s_nu * sgn * s_p
    im_re = (1.0 / r_nu) * c_nu * s_m
    im_im = -(1.0 / r_nu) * s_nu * sgn * s_m
    pref = (math.pi / 2.0) / math.sin(_NU * math.pi)
    k_re = pref * (im_re - ip_re)
    k_im = pref * (im_im - ip_im)
    cw, sw = torch.cos(w), torch.sin(w)
    small_re = k_re * cw - k_im * sw
    small_im = k_re * sw + k_im * cw

    # large branch: Poincare series in 1/z = -i sgn / |w|
    x2 = 1.0 / (aw_large * aw_large)
    n_even = (_ASYMP_TERMS + 1) // 2
    n_odd = _ASYMP_TERMS // 2
    se = torch.full_like(x2, _ASYMP_COEF[2 * (n_even - 1)] * (-1.0) ** (n_even - 1))
    for j in range(n_even - 2, -1, -1):
        se = se * x2 + _ASYMP_COEF[2 * j] * (-1.0) ** j
    so = torch.full_like(x2, _ASYMP_COEF[2 * (n_odd - 1) + 1] * (-1.0) ** (n_odd - 1))
    for j in range(n_odd - 2, -1, -1):
        so = so * x2 + _ASYMP_COEF[2 * j + 1] * (-1.0) ** j
    s_re = se
    s_im = -sgn * so / aw_large
    # sqrt(pi/(2 i w)) = sqrt(pi/(2|w|)) e^{-i pi/4 sgn}
    root = torch.sqrt(math.pi / (2.0 * aw_large))
    c4 = math.cos(math.pi / 4.0)
    pre_re = root * c4
    pre_im = -root * c4 * sgn
    large_re = pre_re * s_re - pre_im * s_im
    large_im = pre_re * s_im + pre_im * s_re

    return torch.where(small, small_re, large_re), torch.where(small, small_im, large_im)


def bessel_jn(n_max: int, x, device=None) -> torch.Tensor:
    """J_n(x) for n = 0..n_max by Miller's backward recurrence, normalized
    by J_0 + 2 sum J_2k = 1, on ``device``, else ``x``'s device, else the
    current CUDA device; a tensor keeps its dtype, other input is float64.
    Returns shape ``(n_max + 1,) + x.shape``."""
    dev = resolve_device(device, x)
    x = x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float64, device=dev)
    m_start = n_max + 16 + int(1.5 * n_max)
    x_safe = torch.where(x == 0, torch.ones_like(x), x)
    jp = torch.zeros_like(x)
    jc = torch.ones_like(x) * 1e-30
    out = [None] * (n_max + 1)
    norm = torch.zeros_like(x)
    for k in range(m_start, 0, -1):
        # J_{k-1} = (2k/x) J_k - J_{k+1}
        jm = (2.0 * k / x_safe) * jc - jp
        jp, jc = jc, jm
        # rescale everything kept so far where the recurrence grows large
        scale = torch.where(torch.abs(jc) > 1e10, 1e-10, 1.0)
        jc = jc * scale
        jp = jp * scale
        norm = norm * scale
        if k - 1 <= n_max:
            out[k - 1] = jc
        if (k - 1) % 2 == 0 and k - 1 > 0:
            norm = norm + 2.0 * jc
        for i in range(len(out)):
            if out[i] is not None and i != k - 1:
                out[i] = out[i] * scale
    norm = norm + jc  # J_0 + 2 sum_k J_2k
    res = torch.stack(out, dim=0) / norm
    n_idx = torch.arange(n_max + 1, device=x.device).reshape((n_max + 1,) + (1,) * x.dim())
    exact0 = torch.where(n_idx == 0, 1.0, 0.0).to(res.dtype)
    return torch.where(x == 0, exact0, res)


__all__ = ["kve_one_third", "kve_one_third_imag", "bessel_jn"]
