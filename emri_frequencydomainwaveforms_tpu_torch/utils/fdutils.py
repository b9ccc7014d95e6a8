"""FD signal-processing utilities: windowing, spectral convolution, adapters.

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.fdutils``:
`get_convolution`, `get_fft_td_windowed`, `get_fd_windowed` and the two
adapter classes are host-side numpy (run once per injection, not in the
sampler's loop), copied from the reference. `dft_at_bins` takes the DFT of
a real series at selected bins: the reference evaluates it as chunked
float32 matmuls because the TPU's FFT of an odd length lowers to a dense
DFT matrix; on the GPU it is ``torch.fft.rfft`` in float64 followed by
indexing, which is exact where the reference's float32 angles carry
~1e-7 rad.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import fftconvolve


def get_convolution(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Circular convolution of ``a`` and ``b`` normalized by ``len(b)``:
    the linear convolution of ``[a[1:], a]`` with ``b`` in 'valid' mode."""
    a = np.asarray(a)
    b = np.asarray(b)
    return fftconvolve(np.hstack((a[1:], a)), b, mode="valid") / len(b)


def dft_at_bins(h: torch.Tensor, bin_idx, n_t: int):
    """``rfft(h)[..., bin_idx]`` of real series ``h`` (..., n_t) as float64
    ``(re, im)``, each (..., len(bin_idx)), on ``h``'s device."""
    spec = torch.fft.rfft(torch.as_tensor(h).to(torch.float64), n=n_t, dim=-1)
    idx = torch.as_tensor(np.asarray(bin_idx), dtype=torch.long, device=spec.device)
    out = spec[..., idx]
    return out.real, out.imag


def get_fft_td_windowed(signal, window, dt: float):
    """FFT of windowed TD channels: ``fftshift(fft(h * w)) * dt``."""
    return [np.fft.fftshift(np.fft.fft(np.asarray(s) * np.asarray(window))) * dt for s in signal]


def get_fd_windowed(signal, window=None, window_in_fd: bool = False):
    """Apply a TD window to FD channels by spectral convolution."""
    if window is None:
        return [np.asarray(s) for s in signal]
    fft_window = np.asarray(window) if window_in_fd else np.fft.fft(np.asarray(window))
    return [get_convolution(np.conj(fft_window), np.asarray(s)) for s in signal]


class get_fd_waveform_fromFD:
    """Adapter: FD generator -> positive-frequency windowed [h+, hx].

    Wraps a ``return_list`` FD generator, applies optional FD-domain
    windowing, masks to positive frequencies and zeroes ``~non_zero_mask``
    bins.
    """

    def __init__(
        self,
        waveform_generator,
        positive_frequency_mask,
        dt,
        non_zero_mask=None,
        window=None,
        window_in_fd=False,
    ):
        self.waveform_generator = waveform_generator
        self.positive_frequency_mask = np.asarray(positive_frequency_mask)
        self.dt = dt
        self.non_zero_mask = None if non_zero_mask is None else np.asarray(non_zero_mask)
        self.window = window
        self.window_in_fd = window_in_fd

    def __call__(self, *args, **kwargs):
        channels = self.waveform_generator(*args, **kwargs)
        channels = get_fd_windowed(channels, self.window, window_in_fd=self.window_in_fd)
        out = [np.asarray(c)[self.positive_frequency_mask].copy() for c in channels]
        if self.non_zero_mask is not None:
            for c in out:
                c[~self.non_zero_mask] = 0.0j
        return out


class get_fd_waveform_fromTD:
    """Adapter: TD generator -> positive-frequency FFT'd windowed [h+, hx]."""

    def __init__(self, waveform_generator, positive_frequency_mask, dt, non_zero_mask=None,
                 window=None):
        self.waveform_generator = waveform_generator
        self.positive_frequency_mask = np.asarray(positive_frequency_mask)
        self.dt = dt
        self.non_zero_mask = None if non_zero_mask is None else np.asarray(non_zero_mask)
        self.window = window  # None -> boxcar

    def __call__(self, *args, **kwargs):
        channels = self.waveform_generator(*args, **kwargs)
        window = np.ones(len(channels[0])) if self.window is None else self.window
        channels = get_fft_td_windowed(channels, window, self.dt)
        out = [np.asarray(c)[self.positive_frequency_mask].copy() for c in channels]
        if self.non_zero_mask is not None:
            for c in out:
                c[~self.non_zero_mask] = 0.0j
        return out


__all__ = [
    "get_convolution",
    "dft_at_bins",
    "get_fft_td_windowed",
    "get_fd_windowed",
    "get_fd_waveform_fromFD",
    "get_fd_waveform_fromTD",
]
