"""The port driven to the independent truths of `truth`.

Each function runs the port at the reference test's own source, modes and
grid on ``device`` (None: the current CUDA device, as every entry point),
and returns what the checks compare; the CPU tests
(``tests/test_torch_golden_fd.py``, ``test_torch_turnover.py``,
``test_torch_real_fold.py``) and ``chip_smoke.py``'s ``[truth]`` phase
share them. Numpy results are float64 on the host.

* `golden_case`: one forced mode of the golden source
  (``tests/test_golden_fd.py:106-152``) through the general kernel, beside
  the scipy SPA pipeline on the port's own knots.
* `synthetic_fold_inputs`: the manufactured quadratic fold as one-mode
  `FDKernelInputs` (``tests/test_turnover.py:39-80``).
* `fd_inputs`: the kernel inputs of a prologue with the scalar
  (channels=False) weights, negative-frequency weights optional.
* `fold_case`: harmonic (2, 10) of a real plunging source, its amplitude
  tapered and refit, beside its brute-force integral
  (``tests/test_real_fold.py:72-150``).
* `plunging_banded`: a plunging source's kernel inputs and its banded
  evaluations with and without the extra slots
  (``tests/test_turnover.py:236-269``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.amplitude import default_mode_table
from ..models.modeselect import table_indices_for
from ..models.summation_fd import FDKernelInputs, fd_mode_sum_uniform, prepare_fd_inputs
from ..models.waveform import _sigma, fd_waveform_core, waveform_prologue
from ..ops.cubic_spline import CubicSplineCoeffs, fit_cubic_spline, spline_eval
from ..utils.device import resolve_device
from . import truth

# tests/test_golden_fd.py: the golden source and its l = 2 candidate table
GOLDEN_SOURCE = (1e6, 50.0, 10.0, 0.4, np.pi / 4, np.pi / 3, 1.0, 1.0, 2.0)
# tests/test_real_fold.py: a 1e6 / 50 source with e0 = 0.5 that plunges at
# ~0.03 yr; its harmonic (m, n) = (2, 10) folds with Airy depth z ~ 9
FOLD_SOURCE = (1e6, 50.0, 7.6, 0.5, 0.7, 0.5, 1.0, 0.0, 0.0)
FOLD_HARMONIC = (2.0, 10.0)
# tests/test_turnover.py: the plunging source of the turnover tests and the
# uniform grid of its banded evaluations
PLUNGING_SOURCE = (1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0)
PLUNGING_GRID = (1e-3, 2.5e-8, 240000)  # f0, df, nf


def golden_case(mode, t_years, n_bins=4096, device=None):
    """One forced mode of the golden source, through the port and through
    the scipy pipeline on the port's knots.

    Returns a dict: ``f_grid`` (the trimmed band), ``golden`` and ``ours``
    (complex, the port's general-kernel positive branch, channels=False),
    ``mm`` (the Hann-weighted mismatch), ``median_rel`` (the interior
    pointwise check), and ``pro`` / ``table`` for a second evaluation.
    """
    table = default_mode_table(30, l_max=2)  # golden modes are l = 2 families
    forced = table_indices_for(table, [mode])
    pro = waveform_prologue(
        *GOLDEN_SOURCE, t_years=t_years, table=table, k_max=1, eps=1e-2,
        forced_idx=forced, device=device,
    )
    n = int(pro.n_live[0])
    t = pro.t_knots[0, :n].cpu().numpy()
    m_i, n_i = mode[1], mode[2]
    phase = (m_i * pro.phi_phi[0, :n] + n_i * pro.phi_r[0, :n]).cpu().numpy()
    idx = int(forced[0])
    a_re = pro.a_re[0, :n, idx].cpu().numpy()
    a_im = pro.a_im[0, :n, idx].cpu().numpy()

    sigma = (-1.0) ** mode[0]
    ym = complex(pro.y_minus[0][0, idx]) + 1j * complex(pro.y_minus[1][0, idx])
    w1 = sigma * ym
    dist_factor = float(pro.dist_factor[0])

    f_grid = truth.golden_grid(t, phase, n_bins)
    golden = truth.golden_fd_positive(t, phase, a_re, a_im, w1, f_grid) * dist_factor
    o1r, o1i, _, _ = fd_waveform_core(
        pro, table, torch.as_tensor(f_grid, device=pro.t_knots.device), channels=False
    )
    ours = o1r[0].cpu().numpy() + 1j * o1i[0].cpu().numpy()
    return dict(
        f_grid=f_grid, golden=golden, ours=ours,
        mm=truth.mismatch(golden, ours, np.hanning(n_bins)),
        median_rel=truth.interior_median_rel(golden, ours), pro=pro, table=table,
    )


def synthetic_fold_inputs(fc=1e-3, b=1e-14, tc=5e5, T=1e6, K=64, device=None):
    """`FDKernelInputs` (B = 1) for one unit-amplitude mode with the
    quadratic fold of `truth.synthetic_fold_knots`: its increasing branch in
    the main slot, its decreasing branch in the turnover slot."""
    dev = resolve_device(device)
    t, phi = truth.synthetic_fold_knots(fc, b, tc, T, K)
    tj = torch.as_tensor(t, dtype=torch.float64, device=dev)[None]
    sp = fit_cubic_spline(tj, torch.as_tensor(phi, dtype=torch.float64, device=dev)[None],
                          bc="not-a-knot")
    f_k = spline_eval(sp, tj, deriv=1) / (2 * np.pi)
    inc_hi = int(np.argmax(np.diff(f_k[0].cpu().numpy()) < 0))
    f64 = dict(dtype=torch.float64, device=dev)

    def one():
        return torch.ones((1, 1), **f64)

    def zero():
        return torch.zeros((1, 1), **f64)

    def i32(v):
        return torch.tensor([[v]], dtype=torch.int32, device=dev)

    ar_c = torch.zeros((1, 1, K - 1, 4), **f64)
    ar_c[..., 0] = 1.0
    return FDKernelInputs(
        t_knots=tj, c_phi_phi=sp.c, c_phi_r=torch.zeros_like(sp.c), f_phi_knots=f_k,
        f_r_knots=torch.zeros_like(tj), ar_c=ar_c, ai_c=torch.zeros((1, 1, K - 1, 4), **f64),
        m_sel=one(), n_sel=zero(), w1_re=one(), w1_im=zero(), w2_re=one(), w2_im=zero(),
        mode_live=one(), n_live=torch.tensor([K], dtype=torch.int32, device=dev),
        n_eff=i32(inc_hi + 1), inc_lo=i32(0), inc_hi=i32(inc_hi), inc_live=one(),
        dec_lo=i32(inc_hi), dec_hi=i32(K - 1), dec_live=one(), power=one(),
        neg_lo=i32(0), neg_hi=i32(0), neg_live=zero(),
        w1n_re=zero(), w1n_im=zero(), w2n_re=zero(), w2n_im=zero(),
    ), (fc, b, tc, T)


def fd_inputs(pro, table, negative=True) -> FDKernelInputs:
    """The kernel inputs of ``pro`` with the scalar weights (htilde at +f
    and the conjugate at -f), and with the negative-frequency branch's
    weights when ``negative``."""
    sig = _sigma(table, pro.t_knots.device)
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    neg = dict(w1n=(ypr, ypi), w2n=(sig * ymr, -sig * ymi)) if negative else {}
    return prepare_fd_inputs(
        pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im, table, pro.sel,
        (sig * ymr, sig * ymi), (ypr, -ypi), **neg,
    )


def fold_case(device=None):
    """Harmonic (2, 10) of `FOLD_SOURCE` alone, unit weights, its amplitude
    tapered by `truth.taper` and refit at the same knots, and the brute-force
    integral of that same signal (`truth.fold_brute_force`).

    Returns the dict of `truth.fold_brute_force` with ``sm``, the one-mode
    `FDKernelInputs` (B = 1) both kernels take.
    """
    table = default_mode_table(16, l_max=2)
    pro = waveform_prologue(
        *FOLD_SOURCE, t_years=1.0, table=table, k_max=32, eps=1e-4, device=device,
    )
    inp = fd_inputs(pro, table)
    m_all = inp.m_sel[0].cpu().numpy()
    n_all = inp.n_sel[0].cpu().numpy()
    hits = np.where((m_all == FOLD_HARMONIC[0]) & (n_all == FOLD_HARMONIC[1]))[0]
    if hits.size != 1:
        raise RuntimeError(f"harmonic {FOLD_HARMONIC} not selected once ({hits.size})")
    j = int(hits[0])
    if not float(inp.dec_live[0, j]) > 0:
        raise RuntimeError(f"harmonic {FOLD_HARMONIC} no longer folds")
    m, n = float(inp.m_sel[0, j]), float(inp.n_sel[0, j])
    ih, dh = int(inp.inc_hi[0, j]), int(inp.dec_hi[0, j])
    t = inp.t_knots[0].cpu().numpy()
    t_end, t_fold = t[dh], t[ih]
    fmode = m * inp.f_phi_knots[0].cpu().numpy() + n * inp.f_r_knots[0].cpu().numpy()
    fc, fend = fmode[ih], fmode[dh]

    # tapered amplitude, refit at the SAME knots (both pipelines share it)
    tk = inp.t_knots[0]
    ar_k = spline_eval(CubicSplineCoeffs(x=tk, c=inp.ar_c[0, j]), tk)
    ai_k = spline_eval(CubicSplineCoeffs(x=tk, c=inp.ai_c[0, j]), tk)
    wk = torch.as_tensor(truth.taper(t, t_end, t_fold), device=tk.device)
    sp_ar = fit_cubic_spline(tk, ar_k * wk, bc="not-a-knot")
    sp_ai = fit_cubic_spline(tk, ai_k * wk, bc="not-a-knot")

    def lane(x):
        return x[:, j:j + 1]

    one, zero = torch.ones_like(lane(inp.m_sel)), torch.zeros_like(lane(inp.m_sel))
    sm = inp._replace(
        ar_c=sp_ar.c[None, None], ai_c=sp_ai.c[None, None], m_sel=lane(inp.m_sel),
        n_sel=lane(inp.n_sel), w1_re=one, w1_im=zero, w2_re=one, w2_im=zero, mode_live=one,
        n_eff=lane(inp.n_eff), inc_lo=lane(inp.inc_lo), inc_hi=lane(inp.inc_hi),
        inc_live=lane(inp.inc_live), dec_lo=lane(inp.dec_lo), dec_hi=lane(inp.dec_hi),
        dec_live=lane(inp.dec_live), power=one, neg_lo=torch.zeros_like(lane(inp.neg_lo)),
        neg_hi=torch.zeros_like(lane(inp.neg_hi)), neg_live=zero, w1n_re=zero, w1n_im=zero,
        w2n_re=zero, w2n_im=zero,
    )

    def host(x):
        return x.cpu().numpy()

    case = truth.fold_brute_force(
        t, host(inp.c_phi_phi[0]), host(inp.c_phi_r[0]), m, n, host(sp_ar.c), host(sp_ai.c),
        t_end, fc, fend,
    )
    case["sm"] = sm
    return case


def fold_banded(case):
    """The production banded kernel on the fold case at its fringe bins:
    runs of 16 bins, 4 turnover slots with 2048-run windows, no negative
    slots (``tests/test_real_fold.py:181-185``). Complex (12,)."""
    bb = fd_mode_sum_uniform(
        case["sm"], case["f0"], case["df"], case["nf"], bins_per_run=16, turnover_slots=4,
        negative_slots=0, extra_band_runs=2048,
    )
    return bb[0][0].cpu().numpy()[case["idx"]] + 1j * bb[1][0].cpu().numpy()[case["idx"]]


def plunging_banded(device=None):
    """`PLUNGING_SOURCE` over 1 yr (16 l = 2 candidates, 32 slots, eps
    1e-2): its kernel inputs with the negative-frequency weights, the banded
    kernel on `PLUNGING_GRID` in runs of 16 bins with 4 turnover and 4
    negative slots (2048-run windows), and the same with no extra slots
    (o1_re only). Returns (inp, (f0, df, nf), banded_full, b0)."""
    table = default_mode_table(16, l_max=2)
    pro = waveform_prologue(
        *PLUNGING_SOURCE, t_years=1.0, table=table, k_max=32, eps=1e-2, device=device,
    )
    inp = fd_inputs(pro, table)
    f0, df, nf = PLUNGING_GRID
    banded_full = fd_mode_sum_uniform(
        inp, f0, df, nf, bins_per_run=16, turnover_slots=4, negative_slots=4,
        extra_band_runs=2048,
    )
    b0 = fd_mode_sum_uniform(inp, f0, df, nf, bins_per_run=16)[0]
    return inp, (f0, df, nf), banded_full, b0


__all__ = [
    "FOLD_HARMONIC",
    "FOLD_SOURCE",
    "GOLDEN_SOURCE",
    "PLUNGING_GRID",
    "PLUNGING_SOURCE",
    "fd_inputs",
    "fold_banded",
    "fold_case",
    "golden_case",
    "plunging_banded",
    "synthetic_fold_inputs",
]
