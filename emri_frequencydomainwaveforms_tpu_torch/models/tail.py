"""Relativistic tail correction for the multipole amplitudes.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.tail``: the
factorized-waveform tail factor (Damour, Iyer & Nagar 2009, eq. 19)

    T_lm(omega) = Gamma(l + 1 - 2 i khat) / Gamma(l + 1)
                  * exp(pi khat) * exp(2 i khat ln(2 |omega| r0)),
    khat = M omega   (geometric units, M = 1 here),

with the complex log-gamma by the g = 7, n = 9 Lanczos approximation. The
arithmetic stays on (re, im) pairs in the reference's operation order, so
the rounding follows it; float64 throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Lanczos g = 7, n = 9 coefficients (Godfrey / Numerical Recipes lineage).
_LANCZOS_G = 7.0
_LANCZOS_C = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)
_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))


def complex_lgamma(z_re: torch.Tensor, z_im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log Gamma(z) for Re z >= 1, on (re, im) pairs (principal branch).

    Lanczos: with w = z - 1, t = w + g + 1/2,
      lgamma(z) = log(2 pi)/2 + (w + 1/2) log t - t + log(sum_k c_k s_k)
    where s_0 = 1, s_k = 1/(w + k).
    """
    z_re, z_im = torch.broadcast_tensors(z_re, z_im)
    w_re = z_re - 1.0
    w_im = z_im

    s_re = torch.full_like(w_re, _LANCZOS_C[0])
    s_im = torch.zeros_like(w_re)
    for k in range(1, len(_LANCZOS_C)):
        d_re = w_re + float(k)
        d_im = w_im
        inv = 1.0 / (d_re * d_re + d_im * d_im)
        s_re = s_re + _LANCZOS_C[k] * d_re * inv
        s_im = s_im - _LANCZOS_C[k] * d_im * inv

    t_re = w_re + (_LANCZOS_G + 0.5)
    t_im = w_im
    log_t_re = 0.5 * torch.log(t_re * t_re + t_im * t_im)
    log_t_im = torch.atan2(t_im, t_re)

    # (w + 1/2) * log t
    a_re = w_re + 0.5
    prod_re = a_re * log_t_re - w_im * log_t_im
    prod_im = a_re * log_t_im + w_im * log_t_re

    log_s_re = 0.5 * torch.log(s_re * s_re + s_im * s_im)
    log_s_im = torch.atan2(s_im, s_re)

    return (
        _HALF_LOG_2PI + prod_re - t_re + log_s_re,
        prod_im - t_im + log_s_im,
    )


def tail_factor(ls, omega: torch.Tensor, r0: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex T_lm(omega) on (re, im) pairs; broadcasts over ``omega``.

    ``ls``: static integer l per mode (last axis); ``omega``: mode
    frequencies M omega_mn (any sign). ``r0``: the tail gauge constant in
    units of M (a frequency-log phase only). |T| -> 1 and arg T -> 0 as
    omega -> 0.
    """
    ls_f = torch.as_tensor(np.asarray(ls, np.float64), device=omega.device)
    khat = omega  # M = 1 units
    two_k = 2.0 * khat

    lg_re, lg_im = complex_lgamma(ls_f + 1.0, -two_k)
    # log Gamma(l+1) (real): via the same Lanczos for exact cancellation
    lg0_re, _ = complex_lgamma(ls_f + 1.0, torch.zeros_like(ls_f))

    abs_omega = torch.clamp_min(torch.abs(omega), 1.0e-300)
    log_mod = lg_re - lg0_re + math.pi * khat
    phase = lg_im + two_k * torch.log(2.0 * abs_omega * r0)

    mod = torch.exp(log_mod)
    return mod * torch.cos(phase), mod * torch.sin(phase)


def tail_modulus_sq(ls, omega: torch.Tensor) -> torch.Tensor:
    """|T_lm|^2 in closed form (no Lanczos), the flux tail weight.

      |T|^2 = prod_{j=1..l} (j^2 + 4 khat^2) / (l!)^2
              * 4 pi khat / (1 - exp(-4 pi khat)),

    evaluated with the exact khat -> 0 limit (= 1).
    """
    ls_np = np.asarray(ls, np.int64)
    dev = omega.device
    khat = omega
    k2_4 = 4.0 * khat * khat

    l_max = int(ls_np.max()) if ls_np.size else 2
    prod = torch.ones_like(khat)
    run = torch.ones_like(khat)
    fact_sq = np.ones(ls_np.shape)
    running_fact = np.ones(ls_np.shape)
    for j in range(1, l_max + 1):
        run = run * (float(j * j) + k2_4)
        running_fact = running_fact * j
        use = ls_np >= j
        prod = torch.where(torch.as_tensor(use, device=dev), run, prod)
        fact_sq = np.where(use, running_fact, fact_sq)
    prod = prod / torch.as_tensor(fact_sq * fact_sq, dtype=khat.dtype, device=dev)

    x = 4.0 * math.pi * khat
    # x / (1 - e^-x), stable at x -> 0 via expm1
    small = torch.abs(x) < 1.0e-12
    x_safe = torch.where(small, torch.ones_like(x), x)
    geom = torch.where(small, 1.0 + x / 2.0, x_safe / (-torch.expm1(-x_safe)))
    return prod * geom


__all__ = ["complex_lgamma", "tail_factor", "tail_modulus_sq"]
