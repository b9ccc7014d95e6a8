"""Separatrix-adapted orbit coordinate shared by the (u, e) tables.

Counterpart of the coordinate part of
``emri_frequencydomainwaveforms_tpu.models.amplitude_backends``: the flux
grid and the eccentric rwz residual are tabulated on
``u = log(p - p_sep(e) + 0.5)``. The grid-interpolated and learned amplitude
backends of that module are not ported yet.
"""

from __future__ import annotations

import torch

from .geodesic import separatrix

_U_SHIFT = 0.5


def u_of_pe(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return torch.log(p - separatrix(e) + _U_SHIFT)


__all__ = ["u_of_pe"]
