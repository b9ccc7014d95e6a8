"""Independent truths for the FD construction, in numpy and scipy alone.

Copies of the reference test suite's yardsticks, carried over unchanged so
that the port is held to the same truth the JAX package is held to; none of
them shares code with either package's kernels:

* the notebook's SPA pipeline (``Tutorial_FD_construction_single_mode.ipynb``
  cells 11-26): scipy ``CubicSpline`` phase and amplitude, the t(f)
  inversion, fdot / fddot by chained spline derivatives and the uniform
  Bessel-K(1/3) factor by ``scipy.special.kve`` (`golden_fd_positive`, the
  Hann-weighted `mismatch`, the band trim `golden_grid` and the interior
  pointwise check `interior_median_rel`; ``tests/test_golden_fd.py``);
* the brute-force oscillatory integral of a manufactured quadratic fold,
  f(t) = fc - b/2 (t - tc)^2 with unit amplitude, by dense trapezoid
  (`synthetic_fold_knots`, `synthetic_fold_brute_force`;
  ``tests/test_turnover.py``);
* the brute-force integral of one folding harmonic of a real plunging
  source on its own (tapered) splines: the amplitude taper `taper`, the
  integral `fold_brute_force` (the shared splines evaluated by
  `cubic_eval`, the same piecewise cubic as both packages' ``spline_eval``)
  and the RMS distance `rms` (``tests/test_real_fold.py``).

``tests/test_torch_truth_copies.py`` holds each copy to the reference
test's own helper on the same inputs. `truth_cases` drives the port to
these truths.
"""

from __future__ import annotations

import numpy as np
from scipy import special
from scipy.interpolate import CubicSpline

# the reference's trapezoid (numpy < 2 names it trapz)
_trapz = getattr(np, "trapezoid", None) or np.trapz


def mismatch(a, b, w=None):
    """Band mismatch, optionally Hann-weighted.

    The Hann weighting mirrors the reference's windowed-mismatch gates
    (``check_mode_by_mode.py:297-309``): at the band edges the two valid
    spline constructions (scipy's independent t(f) spline vs the kernel's
    derivative-consistent inversion) diverge at spline-representation
    level, an intrinsic property of sparse-knot SPA shared by the
    reference, which likewise windows its accuracy metrics.
    """
    if w is None:
        w = np.ones(len(a))
    num = np.abs(np.sum(w * np.conj(a) * b))
    den = np.sqrt(np.sum(w * np.abs(a) ** 2).real * np.sum(w * np.abs(b) ** 2).real)
    return float(1.0 - num / den)


def golden_fd_positive(t, phase, a_re, a_im, w1, f_grid):
    """Notebook cell-26 FD construction in pure numpy/scipy.

    t, phase, a_re, a_im: live trajectory knots of ONE mode.
    w1: complex weight (sigma * Y^-) multiplying C(f).
    f_grid: ascending frequencies strictly inside the mode band.
    """
    phase_sp = CubicSpline(t, phase)
    theo_f = phase_sp.derivative()(t) / (2.0 * np.pi)  # nb cells 11-14
    assert np.all(np.diff(theo_f) > 0), "golden pipeline needs a monotone band"

    time_f_sp = CubicSpline(theo_f, t)  # nb cell 14: t(f)
    fdot_sp = CubicSpline(t, theo_f).derivative()  # nb cell 17
    fddot_sp = CubicSpline(t, fdot_sp(t)).derivative()  # nb cell 26

    t_star = time_f_sp(f_grid)
    fdot = fdot_sp(t_star)
    fddot = fddot_sp(t_star)

    # SPA uniform (Bessel) amplitude, nb cell 26. The notebook computes
    # kv(1/3, arg)*exp(arg); the scaled kve IS that product and stays
    # finite where kv alone over/underflows (|arg| large when fddot ~ 0)
    w = -2.0 * np.pi * fdot**3 / (3.0 * fddot**2)
    # where fddot crosses zero w -> -inf; far in the asymptotic regime the
    # SPA factor is exactly the plain 1/sqrt(fdot) form, so clipping is
    # error-free at |w| ~ 1e8 (scipy kve returns NaN beyond ~1.5e9 on the
    # imaginary axis; the asymptotic truncation at the clip is O(1e-8))
    w = np.clip(w, -1e8, -1e-30)
    arg = 1j * w
    k13 = special.kve(1.0 / 3.0, arg)
    # the notebook's (2/sqrt3)(fdot/|fddot|) prefactor, rewritten through w
    # as sqrt(2|w|/pi)/sqrt(fdot) (algebraically identical for unclipped w),
    # so the clip cancels exactly in the asymptotic limit where
    # F -> e^{i pi/4}/sqrt(fdot), the same overflow-free form the kernel
    # uses (summation_fd.py level-1 envelope)
    f_spa = k13 * np.sqrt(2.0 * np.abs(w) / np.pi) / np.sqrt(fdot)

    a_conj = CubicSpline(t, a_re)(t_star) - 1j * CubicSpline(t, a_im)(t_star)
    psi = phase_sp(t_star) - 2.0 * np.pi * f_grid * t_star
    return a_conj * f_spa * np.exp(1j * psi) * w1


def golden_grid(t, phase, n_bins):
    """The golden band: the independent (scipy) frequency evolution of the
    mode phase, trimmed a bin off each edge so both pipelines interpolate,
    never extrapolate; ``n_bins`` uniform frequencies."""
    theo_f = CubicSpline(t, phase).derivative()(t) / (2.0 * np.pi)
    f_lo, f_hi = theo_f[0], theo_f[-1]
    pad = (f_hi - f_lo) / n_bins
    return np.linspace(f_lo + pad, f_hi - pad, n_bins)


def interior_median_rel(golden, ours):
    """Median pointwise relative error over the band interior (the outer
    twentieth on each side dropped: there the two t(f) inversions differ at
    spline-representation level)."""
    n_bins = len(golden)
    interior = slice(n_bins // 20, -n_bins // 20)
    g, o = golden[interior], ours[interior]
    rel = np.abs(o - g) / np.maximum(np.abs(g), 1e-3 * np.abs(g).max())
    return float(np.median(rel))


def synthetic_fold_knots(fc=1e-3, b=1e-14, tc=5e5, T=1e6, K=64):
    """Knot times and phase of the quadratic fold f(t) = fc - b/2 (t-tc)^2."""
    t = np.linspace(0, T, K)
    phi = 2 * np.pi * (fc * t - (b / 6) * (t - tc) ** 3)
    return t, phi


def synthetic_fold_brute_force(fs, fc=1e-3, b=1e-14, tc=5e5, T=1e6, n=2_000_001):
    """int_0^T exp(i (phi(t) - 2 pi f t)) dt at each f of ``fs``, by the
    trapezoid rule on ``n`` points."""
    tg = np.linspace(0, T, n)
    dt = tg[1] - tg[0]
    phig = 2 * np.pi * (fc * tg - (b / 6) * (tg - tc) ** 3)
    return np.array([_trapz(np.exp(1j * (phig - 2 * np.pi * f * tg)), dx=dt) for f in fs])


def taper(tt, t_end, t_fold):
    """C^1 cosine ramps: up over [0, 0.4 t_end], down over the last quarter
    of the decreasing branch (stationary points of the tested band sit in
    the first ~2/3 of the branch)."""
    up_end = 0.4 * t_end
    dn_a = t_fold + 0.75 * (t_end - t_fold)
    w = np.ones_like(tt)
    r = tt < up_end
    w[r] = 0.5 * (1 - np.cos(np.pi * tt[r] / up_end))
    r = tt > dn_a
    w[r] = 0.5 * (1 + np.cos(np.pi * np.clip((tt[r] - dn_a) / (t_end - dn_a), 0, 1)))
    w[tt >= t_end] = 0.0
    return w


def cubic_eval(x, c, xq):
    """The piecewise cubic ``c`` (n-1, 4) on knots ``x`` (n,) at ``xq``: the
    segment by ``searchsorted(side="right") - 1`` clamped to [0, n-2], then
    c0 + dx (c1 + dx (c2 + dx c3)), as both packages' ``spline_eval``."""
    j = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
    dx = xq - x[j]
    cj = c[j]
    return cj[:, 0] + dx * (cj[:, 1] + dx * (cj[:, 2] + dx * cj[:, 3]))


def fold_brute_force(t_knots, c_phi_phi, c_phi_r, m, n, ar_c, ai_c, t_end, fc, fend):
    """The brute-force truth of one folding harmonic on its shared splines.

    The phase m Phi_phi + n Phi_r and the (tapered) amplitude are evaluated
    on >= 40 samples per cycle over [0, t_end]; the fringe band runs from
    fc - 0.5 B to fc - 0.08 B (B = fc - fend, the fold-to-track-end drop) on
    a uniform grid of df = 2.5e-8 Hz starting at f0 = fc - 0.6 B with nf
    bins, sampled at 12 bins ``idx``. Returns the case dict: the bins ``fs``,
    the integrals ``bv``, their RMS ``scale`` and the grid (f0, df, nf, idx).
    """
    B = fc - fend
    n_pts = int(40 * fc * t_end) + 1
    tg = np.linspace(0.0, t_end, n_pts)
    phig = m * cubic_eval(t_knots, c_phi_phi, tg) + n * cubic_eval(t_knots, c_phi_r, tg)
    ag = cubic_eval(t_knots, ar_c, tg) + 1j * cubic_eval(t_knots, ai_c, tg)
    dt = tg[1] - tg[0]

    # fringe band: fc - 0.5 B .. fc - 0.08 B, ON the uniform bench-like grid
    df = 2.5e-8
    f0 = fc - 0.6 * B
    nf = int(0.75 * B / df)
    idx = np.linspace(0.1 * B / df, 0.52 * B / df, 12).astype(int)
    fs = f0 + idx * df
    bv = np.array(
        [_trapz(ag * np.exp(1j * (phig - 2 * np.pi * f * tg)), dx=dt) for f in fs]
    )
    scale = np.sqrt(np.mean(np.abs(bv) ** 2))
    return dict(fs=fs, bv=bv, scale=scale, f0=f0, df=df, nf=nf, idx=idx)


def rms(k, case):
    """RMS of ``k`` - the brute-force integrals over the fringe bins, per
    their RMS."""
    return float(np.sqrt(np.mean(np.abs(k - case["bv"]) ** 2)) / case["scale"])


__all__ = [
    "cubic_eval",
    "fold_brute_force",
    "golden_fd_positive",
    "golden_grid",
    "interior_median_rel",
    "mismatch",
    "rms",
    "synthetic_fold_brute_force",
    "synthetic_fold_knots",
    "taper",
]
