"""Mode selection: keep the strongest (l, m, n) harmonics, per walker.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.modeselect``:
compact to a static ``k_max`` strongest modes, then apply the eps
cumulative-power criterion as a mask. Ties rank exactly as in the reference:
``lax.top_k`` puts the lower index first among equal powers (a stable
descending sort does the same) and ``jnp.argsort`` is stable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SelectedModes(NamedTuple):
    """Static-size compacted mode set, (B, k_max) per field.

    Attributes:
      idx: int64 indices into the candidate ModeTable.
      mask: float (1.0 keep / 0.0 drop), the eps criterion.
      power: selected per-mode power.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    power: torch.Tensor


def mode_power(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    y_plus_re: torch.Tensor,
    y_plus_im: torch.Tensor,
    y_minus_re: torch.Tensor,
    y_minus_im: torch.Tensor,
    dt_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-mode power sum_k |A_km|^2 (|Y_{lm}|^2 + |Y_{l,-m}|^2).

    ``a_re/a_im``: (..., knots, M); Ylm factors: (..., M); ``dt_weights``:
    (..., knots) masks padded knots. Returns (..., M).
    """
    mag2 = a_re * a_re + a_im * a_im
    if dt_weights is not None:
        mag2 = mag2 * dt_weights[..., :, None]
    ywt = y_plus_re**2 + y_plus_im**2 + y_minus_re**2 + y_minus_im**2
    return torch.sum(mag2, dim=-2) * ywt


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: the k largest along the last axis, ties
    broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_modes(
    power: torch.Tensor, k_max: int, eps: float, order_key: torch.Tensor | None = None
) -> SelectedModes:
    """Top-k_max modes by power, masked to cumulative fraction >= 1 - eps.

    ``power``: (..., n_candidates). ``order_key``: optional per-mode sort key
    of the same shape; when given, the selected modes are reordered
    ascending in it (dead slots last) so slot k keeps a stable physical
    identity across a walker batch.
    """
    k_max = min(k_max, power.shape[-1])
    p_top, idx = top_k_stable(power, k_max)
    total = torch.sum(power, dim=-1, keepdim=True)
    cum = torch.cumsum(p_top, dim=-1)
    # keep mode i if the cumulative power before it is < (1 - eps) * total
    cum_before = cum - p_top
    mask = (cum_before < (1.0 - eps) * total).to(power.dtype)
    if order_key is not None:
        key = torch.where(mask > 0, torch.gather(order_key, -1, idx), torch.inf)
        order = torch.argsort(key, dim=-1, stable=True)
        idx = torch.gather(idx, -1, order)
        mask = torch.gather(mask, -1, order)
        p_top = torch.gather(p_top, -1, order)
    return SelectedModes(idx=idx, mask=mask, power=p_top)


class ModeSelector:
    """The reference selector's call shape, simplified as in the JAX
    package: ``selector(a_re, a_im, y_pr, y_pi, y_mr, y_mi, eps)`` ->
    `SelectedModes` of the table's ``k_max`` strongest modes."""

    def __init__(self, table, k_max: int = 64):
        self.table = table
        self.k_max = k_max

    def __call__(self, a_re, a_im, y_pr, y_pi, y_mr, y_mi, eps: float = 1e-5):
        power = mode_power(a_re, a_im, y_pr, y_pi, y_mr, y_mi)
        return select_modes(power, self.k_max, eps)


def table_indices_for(table, requested) -> np.ndarray:
    """Candidate-table indices of explicit ``mode_selection`` (l, m, n)
    entries (host-side lookup; KeyError for a mode not in the table)."""
    lookup = {
        (int(l), int(m), int(n)): i
        for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
    }
    out = []
    for lmn in requested:
        if lmn not in lookup:
            raise KeyError(f"mode {lmn} not in candidate table")
        out.append(lookup[lmn])
    return np.asarray(out, dtype=np.int32)


__all__ = ["SelectedModes", "mode_power", "top_k_stable", "select_modes", "ModeSelector",
           "table_indices_for"]
