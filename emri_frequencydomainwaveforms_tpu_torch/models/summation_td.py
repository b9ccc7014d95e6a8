"""Time-domain interpolated mode summation, per walker.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.summation_td``
(`td_mode_sum`, `direct_mode_sum`, `DirectModeSum`): spline the sparse
amplitude and phase knots, evaluate them on the dense time grid and sum
``h(t) = sum_lmn A_lmn(t) Y_lm e^{-i(m Phi_phi + n Phi_r)}`` with the
(-m, -n) equatorial partners. As in the reference, one pair of phase
splines serves every mode (a mode's phase is ``m Phi_phi + n Phi_r`` on the
grid), the segment lookup is done once, the phase is formed in float64 and
wrapped to [-pi, pi] before a float32 sin/cos, and the modes accumulate one
after the other into float32 (h_plus, h_cross). Every tensor carries a
leading walker axis B.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.cubic_spline import (
    CubicSplineCoeffs,
    _segment_index,
    fit_cubic_spline,
    spline_eval_at_segments,
)
from .amplitude import ModeTable
from .modeselect import SelectedModes

_TWO_PI = 2.0 * math.pi


def td_mode_sum(
    t_knots: torch.Tensor,  # (B, K) seconds, strictly increasing (padded tail ok)
    phi_phi_knots: torch.Tensor,  # (B, K)
    phi_r_knots: torch.Tensor,  # (B, K)
    a_re_knots: torch.Tensor,  # (B, K, M) amplitudes of the candidate table
    a_im_knots: torch.Tensor,
    table: ModeTable,
    sel: SelectedModes,  # (B, k) fields
    y_plus: tuple[torch.Tensor, torch.Tensor],  # (B, M) re/im of Y_{l, m}
    y_minus: tuple[torch.Tensor, torch.Tensor],  # (B, M) re/im of Y_{l, -m}
    t_grid: torch.Tensor,  # (N,) shared or (B, N) dense output times
    t_end: torch.Tensor,  # (B,): the waveform is zero after this time (plunge)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense TD waveforms -> (h_plus, h_cross), each (B, N) in ``t_grid``'s dtype.

    The modes are the ``sel.idx`` slots of ``table``; the -m partner of every
    mode is added through A_{l,-m,-n} = (-1)^l conj(A_{lmn}).
    """
    dev, dt64 = t_knots.device, t_knots.dtype
    f32 = torch.float32
    n_b = t_knots.shape[0]
    tg = t_grid.expand(n_b, t_grid.shape[-1]).contiguous()
    idx = sel.idx.long()

    def per_slot(values):  # candidate-table values -> (B, k)
        return torch.as_tensor(values, dtype=dt64, device=dev)[idx]

    m_sel = per_slot(table.ms.astype(np.float64))
    n_sel = per_slot(table.ns.astype(np.float64))
    sig_sel = per_slot(((-1.0) ** table.ls).astype(np.float64))

    # shared segment lookup + phases on the grid; not-a-knot as in the FD
    # kernels' splines
    seg = _segment_index(t_knots, tg)
    sp_pp = fit_cubic_spline(t_knots, phi_phi_knots, bc="not-a-knot")
    sp_pr = fit_cubic_spline(t_knots, phi_r_knots, bc="not-a-knot")
    phi_phi_g = spline_eval_at_segments(sp_pp, seg, tg)
    phi_r_g = spline_eval_at_segments(sp_pr, seg, tg)
    live32 = (tg <= t_end[:, None]).to(f32)

    # amplitude splines of the selected modes only
    def take(x):  # (B, K, M) -> (B, k, K)
        return torch.gather(x.transpose(1, 2), 1, idx[..., None].expand(-1, -1, x.shape[1]))

    ar_c = fit_cubic_spline(t_knots[:, None, :], take(a_re_knots), bc="not-a-knot").c
    ai_c = fit_cubic_spline(t_knots[:, None, :], take(a_im_knots), bc="not-a-knot").c

    def ylm(y):
        return [torch.gather(c, 1, idx).to(f32) for c in y]

    ypr, ypi = ylm(y_plus)
    ymr, ymi = ylm(y_minus)
    w_sel = sel.mask.to(f32)

    hp = torch.zeros(tg.shape, dtype=f32, device=dev)
    hc = torch.zeros(tg.shape, dtype=f32, device=dev)
    for i in range(idx.shape[1]):
        # float64 phase combination, wrapped, then float32 sin/cos
        phase = m_sel[:, i, None] * phi_phi_g + n_sel[:, i, None] * phi_r_g
        phase32 = (phase - _TWO_PI * torch.round(phase * (1.0 / _TWO_PI))).to(f32)
        c = torch.cos(phase32)
        s = torch.sin(phase32)
        ar = spline_eval_at_segments(CubicSplineCoeffs(t_knots, ar_c[:, i]), seg, tg).to(f32)
        ai = spline_eval_at_segments(CubicSplineCoeffs(t_knots, ai_c[:, i]), seg, tg).to(f32)
        yr, yi = ypr[:, i, None], ypi[:, i, None]
        zr, zi = ymr[:, i, None], ymi[:, i, None]
        sg = sig_sel[:, i, None].to(f32)
        # direct term A Y_+ e^{-i phase}
        u = ar * yr - ai * yi
        v = ar * yi + ai * yr
        # partner term sigma conj(A) Y_- e^{+i phase}
        up = ar * zr + ai * zi
        vp = ar * zi - ai * zr
        hp_i = u * c + v * s + sg * (up * c - vp * s)
        hx_i = v * c - u * s + sg * (vp * c + up * s)
        w = w_sel[:, i, None] * live32
        # h = h_+ - i h_x  =>  h_+ = Re h, h_x = -Im h
        hp = hp + w * hp_i
        hc = hc - w * hx_i
    return hp.to(tg.dtype), hc.to(tg.dtype)


def direct_mode_sum(
    t_knots, phi_phi_knots, phi_r_knots, a_re_knots, a_im_knots, table, sel,
    y_plus, y_minus, n_live,
):
    """Mode sum evaluated at the trajectory knots themselves (a validation
    tool: no interpolation). Returns (h_plus, h_cross), (B, K); the padded
    knots past ``n_live`` carry zeros."""
    last = (n_live.long() - 1).clamp_min(0)
    t_end = torch.gather(t_knots, 1, last[:, None])[:, 0]
    return td_mode_sum(
        t_knots, phi_phi_knots, phi_r_knots, a_re_knots, a_im_knots,
        table, sel, y_plus, y_minus, t_knots, t_end,
    )


class DirectModeSum:
    """Object form of `direct_mode_sum` over a `WaveformPrologue`."""

    def __init__(self, **kwargs):
        del kwargs

    def __call__(self, pro, table):
        return direct_mode_sum(
            pro.t_knots, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im,
            table, pro.sel, pro.y_plus, pro.y_minus, pro.n_live,
        )


__all__ = ["td_mode_sum", "direct_mode_sum", "DirectModeSum"]
