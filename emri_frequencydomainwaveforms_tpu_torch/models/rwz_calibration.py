"""Strong-field amplitude calibration from the Regge-Wheeler/Zerilli solver.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.rwz_calibration``:
the residual modulus correction

    A_lmn  ->  A_lmn * B_lm(x_mn),      x_mn = (|omega_mn| / m)^(2/3),

with B_lm the exact/model flux ratio on circular Schwarzschild orbits
(`_rwz_calibration_data`), and on top of it the complex eccentric residual
R_lmn(u, e) on the regular (u, e) orbit grid (`_rwz_ecc_data`). Modes without
a calibrated row get B = 1, R = 1.

Both tables are evaluated as index-clamped 4-point Keys/Catmull-Rom stencils
over edge-replicated ghost nodes, by gather. The reference contracts dense
cardinal weight vectors against the whole tables instead (a TPU gather
workaround); the two are the same interpolant, and a gather keeps a float32
matmul, and with it the process-wide TF32 switches, out of the result. The
weights and table values are rounded to float32 where the reference rounds
them, so the two agree to float32 summation order (~2e-6 of |B R|).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _rwz_ecc_data as _ecc
from ._rwz_calibration_data import B_TABLE, N_X, X_HI, X_LO

_LOG_LO = float(np.log(X_LO))
_DT = float((np.log(X_HI) - np.log(X_LO)) / (N_X - 1))


def _mode_rows(ls: np.ndarray, ms: np.ndarray) -> np.ndarray:
    """(n_modes, N_X + 2) static B rows with edge-replicated ghost nodes
    (reproducing the index-clamped Catmull-Rom stencil exactly);
    uncalibrated modes get ones."""
    ones = np.ones(N_X)
    rows = np.stack(
        [B_TABLE.get((int(l), int(abs(m))), ones) for l, m in zip(np.asarray(ls), np.asarray(ms))]
    )
    return np.concatenate([rows[:, :1], rows, rows[:, -1:]], axis=1)


def _ecc_rows(ls: np.ndarray, ms: np.ndarray, ns: np.ndarray) -> np.ndarray:
    """(N_U + 2, N_E + 2, n_modes, 2) float32 (re, im) R rows with
    edge-replicated ghosts, node axes first so one stencil node of every
    mode is one contiguous row; uncalibrated modes get 1 + 0i."""
    ones = np.ones((_ecc.N_U, _ecc.N_E), dtype=complex)
    rows = np.stack(
        [
            _ecc.R_TABLE.get((int(l), int(m), int(n)), ones)
            for l, m, n in zip(np.asarray(ls), np.asarray(ms), np.asarray(ns))
        ]
    )  # (M, N_U, N_E)
    rows = np.concatenate([rows[:, :1], rows, rows[:, -1:]], axis=1)
    rows = np.concatenate([rows[:, :, :1], rows, rows[:, :, -1:]], axis=2)
    pair = np.stack([rows.real, rows.imag], axis=-1).astype(np.float32)
    return np.ascontiguousarray(pair.transpose(1, 2, 0, 3))


def rwz_rows(ls, ms, ns, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ghost-padded float32 tables of a mode list on ``device``:
    B rows (n_modes, N_X + 2) and R rows (N_U + 2, N_E + 2, n_modes, 2).
    A batch-frozen module builds them once and passes them back in."""
    return (
        torch.as_tensor(_mode_rows(ls, ms), dtype=torch.float32, device=device),
        torch.as_tensor(_ecc_rows(ls, ms, ns), device=device),
    )


def _keys_cardinal(s: torch.Tensor) -> torch.Tensor:
    """Keys/Catmull-Rom cardinal c(s) (a = -1/2), support |s| < 2."""
    a = torch.abs(s)
    inner = (1.5 * a - 2.5) * a * a + 1.0
    outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return torch.where(a < 1.0, inner, torch.where(a < 2.0, outer, torch.zeros_like(a)))


def _stencil(t: torch.Tensor, n: int):
    """For float32 node coordinates ``t`` in [0, n - 1]: the first padded
    node index of the 4-point stencil and its 4 cardinal weights (node j is
    padded index j + 1, so the stencil i-1..i+2 starts at padded index i)."""
    i = torch.floor(t).clamp(0.0, n - 2.0)
    w = [_keys_cardinal(t - (i + float(a - 1))) for a in range(4)]
    return i.long(), w


def rwz_correction(ls, ms, x: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
    """B_lm(x) per mode; ``x`` shaped (..., n_modes) (static ls/ms).

    Catmull-Rom on the uniform log-x grid, clamped to the table's range.
    ``rows``: the B rows of `rwz_rows` already on the device.
    """
    if rows is None:
        rows = torch.as_tensor(_mode_rows(ls, ms), dtype=torch.float32, device=x.device)
    t = (torch.log(torch.clamp_min(x, 1e-30)) - _LOG_LO) / _DT
    t = torch.clamp(t, 0.0, N_X - 1.0).to(torch.float32)
    i, w = _stencil(t, N_X)
    rows_b = rows.expand(x.shape + rows.shape[-1:])
    out = 0.0
    for a in range(4):
        out = out + w[a] * torch.gather(rows_b, -1, (i + a)[..., None])[..., 0]
    return out.to(x.dtype)


def rwz_ecc_residual(
    ls, ms, ns, u: torch.Tensor, e: torch.Tensor, rows: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex eccentric residual R_lmn(u, e) per mode -> (re, im) pair
    ((1, 0) where uncalibrated).

    ``u``/``e`` are the trajectory coordinates (u = log(p - p_sep + 0.5),
    `amplitude_backends.u_of_pe`), shaped (...); outputs are (..., n_modes).
    Keys-cardinal bicubic with edge-replicated ghosts (node-exact, C^1); the
    interpolated modulus is clamped back into [0.15, 6.0], the band the
    table's generator accepts, since the cubic can overshoot between sharp
    node-scale jumps. ``rows``: the R rows of `rwz_rows` on the device.
    """
    dt = u.dtype
    if rows is None:
        rows = torch.as_tensor(_ecc_rows(ls, ms, ns), device=u.device)
    tu = (u - _ecc.U0) / _ecc.DU
    te = (e - _ecc.E0) / _ecc.DE
    tu = torch.clamp(tu, 0.0, _ecc.N_U - 1.0).to(torch.float32)
    te = torch.clamp(te, 0.0, _ecc.N_E - 1.0).to(torch.float32)
    iu, wu = _stencil(tu, _ecc.N_U)
    ie, we = _stencil(te, _ecc.N_E)

    out = 0.0
    for b in range(4):  # u inner, then e, as the reference contracts
        inner = 0.0
        for a in range(4):
            inner = inner + wu[a][..., None, None] * rows[iu + a, ie + b]
        out = out + inner * we[b][..., None, None]
    r_re, r_im = out[..., 0], out[..., 1]
    mag = torch.sqrt(r_re * r_re + r_im * r_im)
    scale = torch.clamp(mag, 0.15, 6.0) / torch.clamp_min(mag, 1e-30)
    return (r_re * scale).to(dt), (r_im * scale).to(dt)


__all__ = ["rwz_rows", "rwz_correction", "rwz_ecc_residual"]
