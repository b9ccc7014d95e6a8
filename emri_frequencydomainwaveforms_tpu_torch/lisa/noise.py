"""FD noise realizations.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.noise``: host-side
numpy, the same draws from the same seed.
"""

from __future__ import annotations

import numpy as np

from .sensitivity import get_sensitivity


def generate_noise_fd(freqs, df=None, *, sens_fn="lisasens", seed=None, **sens_kwargs):
    """One-sided FD Gaussian noise realization on ``freqs`` (numpy complex).

    Real and imaginary parts are each N(0, 1) scaled by
    ``sqrt(PSD) * 0.5 * sqrt(1/df)``, so ``<|n(f)|^2> = PSD/(2 df)`` per bin
    (consistent with the ``4 df / PSD`` whitened inner product).
    """
    freqs = np.asarray(freqs)
    if df is None:
        df = freqs[1] - freqs[0] if len(freqs) > 1 else 1.0
    psd = np.asarray(get_sensitivity(freqs, sens_fn=sens_fn, **sens_kwargs))
    rng = np.random.default_rng(seed)
    norm = 0.5 * np.sqrt(1.0 / df)
    re = rng.standard_normal(freqs.shape)
    im = rng.standard_normal(freqs.shape)
    return np.sqrt(psd) * (re + 1j * im) * norm


__all__ = ["generate_noise_fd"]
