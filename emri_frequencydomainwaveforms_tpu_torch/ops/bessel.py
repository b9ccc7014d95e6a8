"""Scaled modified Bessel ``K_{1/3}(i w) e^{i w}`` for the SPA correction.

Counterpart of ``emri_frequencydomainwaveforms_tpu.ops.bessel``
(`kve_one_third_imag` only): ascending series through ``I_{+-1/3}`` for
``|w| < 8``, Poincare asymptotic series above, in real arithmetic and in the
dtype of ``w`` (float32 on the FD level-1 path, as in the reference).
"""

from __future__ import annotations

import math

import torch

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


__all__ = ["kve_one_third_imag"]
