"""Taper windows matching the numpy / scipy definitions.

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.windows``: float64
tensors of length ``n`` on ``device`` (default the CPU; a window is set-up
data, cheap to move).
"""

from __future__ import annotations

import math

import torch


def _cosine_window(n: int, coefs, device=None) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    x = 2.0 * math.pi * k / (n - 1)
    out = torch.zeros((n,), dtype=torch.float64, device=device)
    for j, a in enumerate(coefs):
        out = out + ((-1.0) ** j) * a * torch.cos(j * x)
    return out


def boxcar(n: int, device=None) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float64, device=device)


def hann(n: int, device=None) -> torch.Tensor:
    """Matches ``np.hanning(n)``."""
    return _cosine_window(n, (0.5, 0.5), device)


def blackman(n: int, device=None) -> torch.Tensor:
    """Matches ``np.blackman(n)``."""
    return _cosine_window(n, (0.42, 0.5, 0.08), device)


def nuttall(n: int, device=None) -> torch.Tensor:
    """Matches ``scipy.signal.windows.nuttall(n)`` (sym)."""
    return _cosine_window(n, (0.3635819, 0.4891775, 0.1365995, 0.0106411), device)


WINDOWS = {"boxcar": boxcar, "hann": hann, "blackman": blackman, "nuttall": nuttall}

__all__ = ["boxcar", "hann", "blackman", "nuttall", "WINDOWS"]
