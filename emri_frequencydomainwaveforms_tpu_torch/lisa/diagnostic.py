"""Noise-weighted inner products, overlap, mismatch and SNR.

Counterpart of the host-side core of
``emri_frequencydomainwaveforms_tpu.lisa.diagnostic`` (`inner_product`,
`overlap`, `get_mismatch`, `snr`, `scale_snr`): numpy on complex channels,
run once per injection, not in the sampler's loop. The Fisher and covariance diagnostics are not
ported.
"""

from __future__ import annotations

import numpy as np

from .sensitivity import get_sensitivity


def _as_channel_list(sig):
    if isinstance(sig, (list, tuple)):
        return [np.asarray(s) for s in sig]
    return [np.asarray(sig)]


def _df_vector(f):
    """Right-rule frequency spacings with df[0] = df[1]."""
    f = np.asarray(f)
    df = np.empty_like(f)
    df[1:] = np.diff(f)
    df[0] = df[1] if len(f) > 1 else 1.0
    return df


def inner_product(
    sig1,
    sig2,
    *,
    f_arr=None,
    dt=None,
    df=None,
    PSD="lisasens",
    PSD_args=(),
    PSD_kwargs=None,
    normalize=False,
):
    """<a|b> = 4 Re sum df a*(f) b(f) / PSD(f), summed over channels.

    Frequency-domain inputs with ``f_arr``; time-domain inputs with ``dt``
    (rFFT'd here). ``PSD`` is a `get_sensitivity` name or a function of the
    frequencies. ``normalize=True`` returns the overlap <a|b>/sqrt(<a|a><b|b>).
    """
    PSD_kwargs = PSD_kwargs or {}
    a = _as_channel_list(sig1)
    b = _as_channel_list(sig2)
    if len(a) != len(b):
        raise ValueError("channel count mismatch")

    if dt is not None:  # TD inputs
        n = len(a[0])
        freqs = np.fft.rfftfreq(n, dt)[1:]
        a = [np.fft.rfft(ch)[1:] * dt for ch in a]
        b = [np.fft.rfft(ch)[1:] * dt for ch in b]
        f_arr = freqs

    if f_arr is None:
        raise ValueError("provide f_arr (FD inputs) or dt (TD inputs)")
    f_arr = np.asarray(f_arr)
    dfv = _df_vector(f_arr) if df is None else np.full(f_arr.shape, df)

    if callable(PSD):
        psd = np.asarray(PSD(f_arr, *PSD_args, **PSD_kwargs))
    else:
        psd = np.asarray(get_sensitivity(f_arr, sens_fn=PSD, **PSD_kwargs))

    out = 0.0
    for ca, cb in zip(a, b):
        out = out + 4.0 * np.sum(dfv * np.real(np.conj(ca) * cb) / psd)
    if normalize:
        if dt is not None:
            raise NotImplementedError("normalize with TD inputs: call with FD arrays")
        kw = dict(f_arr=f_arr, df=df, PSD=PSD, PSD_args=PSD_args, PSD_kwargs=PSD_kwargs)
        naa = inner_product(sig1, sig1, **kw)
        nbb = inner_product(sig2, sig2, **kw)
        return out / np.sqrt(naa * nbb)
    return out


def overlap(sig1, sig2, **kwargs):
    return inner_product(sig1, sig2, normalize=True, **kwargs)


def get_mismatch(sig1, sig2, **kwargs):
    """1 - overlap."""
    return 1.0 - overlap(sig1, sig2, **kwargs)


def snr(sig, data=None, **kwargs):
    """Optimal SNR sqrt(<h|h>), or matched-filter SNR <d|h>/sqrt(<h|h>)."""
    opt = np.sqrt(inner_product(sig, sig, **kwargs))
    if data is None:
        return opt
    return inner_product(data, sig, **kwargs) / opt


def scale_snr(target_snr, sig, **kwargs):
    """Rescale channels to a target optimal SNR: (channels, factor)."""
    current = snr(sig, **kwargs)
    factor = target_snr / current
    return [s * factor for s in _as_channel_list(sig)], factor


__all__ = ["inner_product", "overlap", "get_mismatch", "snr", "scale_snr"]
