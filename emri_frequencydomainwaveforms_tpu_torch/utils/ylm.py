"""Spin-weighted spherical harmonics (s = -2).

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.ylm``: the Goldberg
et al. (1967) closed form, with the (l, m) coefficients and integer
exponents tabulated on the host and contracted against powers of
cos/sin(theta/2) on the device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .device import resolve_device


def _binom(n: int, k: int) -> float:
    if k < 0 or k > n:
        return 0.0
    return math.comb(n, k)


@lru_cache(maxsize=None)
def _ylm_terms(l: int, m: int, s: int = -2) -> tuple[tuple[float, int, int], ...]:
    """(coef, pow_cos, pow_sin) terms of sY_lm as polynomial in cos/sin(th/2)."""
    if l < abs(s) or abs(m) > l:
        return ((0.0, 0, 0),)
    pref = (-1.0) ** m * math.sqrt(
        math.factorial(l + m)
        * math.factorial(l - m)
        * (2 * l + 1)
        / (4.0 * math.pi * math.factorial(l + s) * math.factorial(l - s))
    )
    terms = []
    for r in range(0, l - s + 1):
        c1 = _binom(l - s, r)
        c2 = _binom(l + s, r + s - m)
        if c1 == 0.0 or c2 == 0.0:
            continue
        sign = (-1.0) ** (l - r - s)
        pc = 2 * r + s - m
        ps = 2 * l - 2 * r - s + m
        if pc < 0 or ps < 0:
            continue
        terms.append((pref * c1 * c2 * sign, pc, ps))
    return tuple(terms) if terms else ((0.0, 0, 0),)


def _build_tables(ls: np.ndarray, ms: np.ndarray, s: int = -2):
    """Padded (coef, pow_cos, pow_sin) tables for a static mode list."""
    all_terms = [_ylm_terms(int(l), int(m), s) for l, m in zip(ls, ms)]
    kmax = max(len(t) for t in all_terms)
    coef = np.zeros((len(all_terms), kmax))
    pc = np.zeros((len(all_terms), kmax))
    ps = np.zeros((len(all_terms), kmax))
    for i, terms in enumerate(all_terms):
        for k, (c, a, b) in enumerate(terms):
            coef[i, k] = c
            pc[i, k] = a
            ps[i, k] = b
    return coef, pc, ps


def spin_weighted_ylm(
    ls, ms, theta: torch.Tensor, phi: torch.Tensor, s: int = -2
) -> tuple[torch.Tensor, torch.Tensor]:
    """sY_lm(theta, phi) for a static (l, m) list.

    ``ls``/``ms`` are host integers (numpy); ``theta``/``phi`` are float64
    tensors that broadcast against each other (``(B,)`` for a walker batch).
    Returns (re, im), each of shape ``broadcast(theta, phi).shape + (M,)``.
    """
    ls = np.asarray(ls, dtype=np.int64)
    ms = np.asarray(ms, dtype=np.int64)
    coef, pc, ps = _build_tables(ls, ms, s)
    theta, phi = torch.broadcast_tensors(theta, phi)
    dev, dt = theta.device, theta.dtype
    c2 = torch.cos(theta / 2.0)[..., None, None]
    s2 = torch.sin(theta / 2.0)[..., None, None]
    # 0^0 == 1 for the integer exponents
    mag = torch.sum(
        torch.as_tensor(coef, dtype=dt, device=dev)
        * torch.pow(c2, torch.as_tensor(pc, dtype=dt, device=dev))
        * torch.pow(s2, torch.as_tensor(ps, dtype=dt, device=dev)),
        dim=-1,
    )
    mphi = torch.as_tensor(ms.astype(np.float64), dtype=dt, device=dev) * phi[..., None]
    return mag * torch.cos(mphi), mag * torch.sin(mphi)


class GetYlms:
    """The reference's Ylm generator: complex numpy out.

    With ``assume_positive_m=True`` a call with (l, m >= 0) arrays returns
    the 2n array ``[Y_{l,m}..., Y_{l,-m}...]``, as the reference does.
    ``device``: where the harmonics are computed (default a tensor
    argument's, else the current CUDA device).
    """

    def __init__(self, assume_positive_m: bool = False, use_gpu: bool = None, device=None):
        del use_gpu
        self.assume_positive_m = assume_positive_m
        self.device = device

    def __call__(self, ls, ms, theta, phi):
        ls = np.asarray(ls)
        ms = np.asarray(ms)
        if self.assume_positive_m:
            ls = np.concatenate([ls, ls])
            ms = np.concatenate([ms, -ms])
        dev = resolve_device(self.device, theta, phi)
        theta, phi = (torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (theta, phi))
        re, im = spin_weighted_ylm(ls, ms, theta, phi)
        return re.cpu().numpy() + 1j * im.cpu().numpy()


__all__ = ["spin_weighted_ylm", "GetYlms"]
