"""All-mode frequency-domain spectra by the stationary-phase approximation,
bin by bin, on a uniform positive grid (the notebook's construction that
the repo's golden test also follows: t(f) by inversion, the uniform
Bessel-K(1/3) factor by ``scipy.special.kve``).

A harmonic (l, m, n) of amplitude A(t) and phase Phi_mn(t) = m Phi_phi +
n Phi_r contributes, on a branch of its frequency f(t) = Phi_mn'(t) / 2 pi
where f rises (falls),

  C(f) = conj(A(t*)) F(t*) exp(i (Phi_mn(t*) - 2 pi f t*)),   f(t*) = f,
  F = K(1/3)(i w) e^{i w} sqrt(2 |w| / pi) / sqrt(|fdot|),
  w = -2 pi |fdot|^3 / (3 fddot^2)   (the complex conjugate where f falls),

and h+ = sum C W1, hx = sum C W2 with W1 = (sigma Y_{l,-m} + conj Y_lm) / 2,
W2 = i (sigma Y_{l,-m} - conj Y_lm) / 2, sigma = (-1)^l, times the
distance factor. A harmonic's rising branch is the first stretch of its
trajectory where f > 0 rises, its falling branch the first where f > 0
falls; each is kept to the bins of its window.
"""

from __future__ import annotations

import numpy as np
from scipy import special
from scipy.interpolate import CubicSpline

from . import physics as ph
from .trajectory import Inspiral

_AMP_CHUNK = 64


def _first_run(ok):
    """(lo, hi) table indices of the first run of segments where ``ok``
    holds, at least three segments long, or None."""
    idx = np.flatnonzero(ok)
    if len(idx) == 0:
        return None
    lo = idx[0]
    stop = np.flatnonzero(~ok[lo:])
    hi = lo + (stop[0] if len(stop) else len(ok) - lo)
    return (lo, hi) if hi - lo >= 3 else None


def branches(f):
    """The rising and the falling branch of a harmonic on the table."""
    d = np.diff(f)
    pos = (f[:-1] > 0) & (f[1:] > 0)
    return _first_run((d > 0) & pos), _first_run((d < 0) & pos)


def amplitude_splines(insp: Inspiral, modes: ph.Modes, physics: dict):
    """Cubic splines in t of Re and Im A_lmn along the trajectory."""
    kw = dict(tail=physics["tail"], factorized=physics["factorized"], rwz=physics["rwz"])
    a = np.concatenate([ph.amplitudes(insp.p[i:i + _AMP_CHUNK], insp.e[i:i + _AMP_CHUNK],
                                      modes, **kw)
                        for i in range(0, len(insp.p), _AMP_CHUNK)])
    return CubicSpline(insp.t, a.real), CubicSpline(insp.t, a.imag), a


def branch_spectrum(insp: Inspiral, j, m, n, amp, rng, bins, f0, df, dirn):
    """C(f) of harmonic ``j`` (m, n) on bins ``bins`` (indices) of the grid
    that lie inside the branch ``rng`` = (lo, hi) of the table."""
    f, fdot, fdot_sp = insp.mode(m, n)
    lo, hi = rng
    tb, fb_tab = insp.t[lo:hi + 1], f[lo:hi + 1]
    f_lo, f_hi = sorted((fb_tab[0], fb_tab[-1]))
    fb = f0 + df * bins
    keep = (fb > f_lo) & (fb < f_hi)
    bins, fb = bins[keep], fb[keep]
    if len(bins) == 0:
        return bins, np.zeros(0, complex)
    order = np.argsort(fb_tab)
    t_of_f = CubicSpline(fb_tab[order], tb[order])
    f_of_t = CubicSpline(tb, fb_tab)
    ts = t_of_f(fb)
    for _ in range(2):
        ts = np.clip(ts - (f_of_t(ts) - fb) / fdot_sp(ts), tb[0], tb[-1])
    fd, fdd = np.abs(fdot_sp(ts)), fdot_sp(ts, 1)
    w = np.clip(-2.0 * np.pi * fd ** 3 / (3.0 * np.maximum(fdd * fdd, 1e-300)), -1e8, -1e-30)
    spa = special.kve(1.0 / 3.0, 1j * w) * np.sqrt(2.0 * np.abs(w) / np.pi) / np.sqrt(fd)
    if dirn < 0:
        spa = np.conj(spa)
    pp, pr = insp.phases(ts)
    a = amp[0](ts)[:, j] + 1j * amp[1](ts)[:, j]
    return bins, np.conj(a) * spa * np.exp(1j * (m * pp + n * pr - 2.0 * np.pi * fb * ts))


def channel_weights(modes: ph.Modes, theta, phi, dist_factor):
    yp = ph.spin_weighted_ylm(modes.ls, modes.ms, theta, phi)
    ym = ph.spin_weighted_ylm(modes.ls, -modes.ms, theta, phi)
    sig = (-1.0) ** modes.ls
    return ((sig * ym + np.conj(yp)) / 2 * dist_factor,
            1j * (sig * ym - np.conj(yp)) / 2 * dist_factor, yp, ym)


def source_spectra(insp: Inspiral, modes: ph.Modes, physics: dict, theta, phi, dist_factor,
                   f0, df, nf, windows=None, turnover=None):
    """(h+, hx) complex on the grid f0 + i df, i < nf. ``windows``: per
    mode (first bin, end bin) of its rising branch, None for the whole
    grid; ``turnover``: (slots, (first, end)): the falling branches of the
    first ``slots`` harmonics in the order given that have one, inside
    that window."""
    bins = np.arange(nf)
    w1, w2, _, _ = channel_weights(modes, theta, phi, dist_factor)
    amp = amplitude_splines(insp, modes, physics)
    hp = np.zeros(nf, complex)
    hc = np.zeros(nf, complex)

    def add(j, rng, window, dirn):
        sel = bins if window is None else bins[(bins >= window[0]) & (bins < window[1])]
        b, c = branch_spectrum(insp, j, modes.ms[j], modes.ns[j], amp, rng, sel, f0, df, dirn)
        hp[b] += c * w1[j]
        hc[b] += c * w2[j]

    falling = []
    for j in range(len(modes)):
        f = insp.mode(modes.ms[j], modes.ns[j])[0]
        rise, fall = branches(f)
        if rise is not None:
            add(j, rise, None if windows is None else windows[j], +1)
        if fall is not None:
            falling.append((j, fall))
    if turnover is not None:
        slots, window = turnover
        for j, fall in falling[:slots]:
            add(j, fall, window, -1)
    return hp, hc


def mode_power(insp: Inspiral, modes: ph.Modes, physics: dict, theta, phi):
    """The selection's power of each harmonic: the time average of |A|^2
    along the trajectory times |Y_lm|^2 + |Y_l,-m|^2."""
    _, _, a = amplitude_splines(insp, modes, physics)
    _, _, yp, ym = channel_weights(modes, theta, phi, 1.0)
    dt = np.gradient(insp.t)
    return (np.abs(a) ** 2 * dt[:, None]).sum(0) / dt.sum() * (np.abs(yp) ** 2 + np.abs(ym) ** 2)


def strongest(power, k_max):
    """Indices of the k_max strongest harmonics, ties to the lower index."""
    return np.argsort(-power, kind="stable")[:k_max]
