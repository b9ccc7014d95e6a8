"""Integrated autocorrelation time estimators (batched, host-side numpy).

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.autocorr`` (its own
copy: this package imports nothing of the JAX one). Sokal's (1989)
automated-window IAT, on the walker-mean chain (Goodman-Weare 2010) or on
the walker-averaged per-chain ACF (emcee), over one batched primitive:
`acf_batch`, the zero-padded FFT autocorrelation of ``(..., nsteps)`` series
in one vectorized pass. The chain lives on the CPU (the sampler's state is
host float64), so this module is numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np


def next_pow_two(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def acf_batch(x: np.ndarray, norm: bool = True) -> np.ndarray:
    """Autocorrelation functions of a batch of series.

    Args:
      x: (..., nsteps) real series (any leading batch shape).
      norm: divide each ACF by its lag-0 value.

    Returns:
      (..., nsteps) ACFs, computed by zero-padded FFT (circular-correlation
      aliasing removed by 2x padding).
    """
    x = np.asarray(x, dtype=np.float64)
    nsteps = x.shape[-1]
    nfft = 2 * next_pow_two(nsteps)
    f = np.fft.rfft(x - x.mean(axis=-1, keepdims=True), n=nfft, axis=-1)
    acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=-1)[..., :nsteps]
    if norm:
        lag0 = acf[..., :1]
        acf = np.divide(acf, lag0, out=np.zeros_like(acf), where=lag0 != 0)
    return acf


def _sokal_tau(acf: np.ndarray, c: float) -> np.ndarray:
    """Windowed IAT from normalized ACF(s), Sokal's automated criterion.

    tau(M) = 2 sum_{k<=M} rho_k - 1, evaluated at the first window M with
    M >= c * tau(M) (falling back to the full length). Vectorized over any
    leading batch shape.
    """
    taus = 2.0 * np.cumsum(acf, axis=-1) - 1.0
    lags = np.arange(acf.shape[-1])
    crossed = lags >= c * taus
    # first crossing per series; argmax of False-only rows returns 0, so
    # patch those to the last lag
    window = np.argmax(crossed, axis=-1)
    window = np.where(crossed.any(axis=-1), window, acf.shape[-1] - 1)
    return np.take_along_axis(taus, window[..., None], axis=-1)[..., 0]


def auto_window(taus, c: float) -> int:
    """First window index M with M >= c * taus[M] (Sokal criterion)."""
    crossed = np.arange(len(taus)) >= c * np.asarray(taus)
    return int(np.argmax(crossed)) if crossed.any() else len(taus) - 1


def autocorr_func_1d(x, norm: bool = True) -> np.ndarray:
    """Single-series ACF."""
    x = np.atleast_1d(x)
    if x.ndim != 1:
        raise ValueError("invalid dimensions for 1D autocorrelation function")
    return acf_batch(x, norm=norm)


def autocorr_gw2010(y, c: float = 5.0) -> float:
    """IAT of the walker-mean chain (Goodman-Weare 2010 estimator)."""
    y = np.atleast_2d(y)  # (nwalkers, nsteps)
    return float(_sokal_tau(acf_batch(y.mean(axis=0)), c))


def autocorr_new(y, c: float = 5.0) -> float:
    """IAT from the walker-averaged ACF (emcee estimator)."""
    y = np.atleast_2d(y)  # (nwalkers, nsteps)
    return float(_sokal_tau(acf_batch(y).mean(axis=0), c))


def get_acf(x, axis: int = 0, average_walkers: bool = False) -> np.ndarray:
    """ACFs along ``axis`` of a chain array."""
    x = np.moveaxis(np.asarray(x), axis, -1)
    if average_walkers and x.ndim > 1:
        # walker axis is the one that followed ``axis`` in the original
        x = x.mean(axis=0)
    acf = acf_batch(x)
    return np.moveaxis(acf, -1, axis)


def get_integrated_act(x, c: float = 5.0, average_walkers: bool = True):
    """Integrated ACT per parameter of a ``(nsteps, nwalkers, *param)`` chain.

    1-D input: single series; 2-D: (nsteps, nwalkers); >=3-D: one IAT per
    trailing parameter index, each from the walker-averaged ACF.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        return autocorr_new(x[None, :], c=c)
    if x.ndim == 2:
        return autocorr_new(x.T, c=c)
    flat = x.reshape(x.shape[0], x.shape[1], -1)  # (nsteps, nwalkers, P)
    batch = np.transpose(flat, (2, 1, 0))  # (P, nwalkers, nsteps)
    taus = _sokal_tau(acf_batch(batch).mean(axis=1), c)  # (P,)
    return taus.reshape(x.shape[2:])


def thermodynamic_integration_log_evidence(betas, logls):
    """log Z via thermodynamic integration over the temperature ladder.

    Args:
      betas: (ntemps,) inverse temperatures, descending, beta[0] = 1.
      logls: (ntemps,) mean log-likelihood per rung.

    Returns:
      (logZ, dlogZ-estimate) using trapezoid + half-grid error estimate.
    """
    betas = np.asarray(betas)
    logls = np.asarray(logls)
    order = np.argsort(betas)[::-1]
    betas, logls = betas[order], logls[order]
    if betas[-1] != 0.0:
        betas = np.append(betas, 0.0)
        logls = np.append(logls, logls[-1])
    logz = -np.trapezoid(logls, betas)
    logz2 = -np.trapezoid(logls[::2], betas[::2])
    return logz, np.abs(logz - logz2)


__all__ = [
    "next_pow_two",
    "acf_batch",
    "autocorr_func_1d",
    "auto_window",
    "autocorr_gw2010",
    "autocorr_new",
    "get_acf",
    "get_integrated_act",
    "thermodynamic_integration_log_evidence",
]
