"""The waveform model of the cells, written from its equations in NumPy and
SciPy: geodesic, multipole amplitudes with their tail, resummation and
strong-field corrections, the multipole flux table, spin-weighted harmonics.

Shared with the program are only the model's data: the multipole constants
C_lm (`FAMILIES`), the resummation series (`RHO`, `DELTA`), the two
calibration tables (`tables/`, copies of the program's data files) and the
physical constants. Every function is computed here in float64; the program
computes its amplitudes in float32, so the two agree to ~1e-6 of a mode.

Units: geometric (G = c = 1, central mass M = 1) unless a name says Hz or s.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import special

from .tables import rwz_circular, rwz_eccentric

# physical constants (the program's values: the time unit sets every phase)
C_SI = 299_792_458.0
GMSUN = 1.32712440041279419e20
MTSUN_SI = GMSUN / C_SI**3
MRSUN_SI = GMSUN / C_SI**2
GPC_SI = 1.0e9 * 3.0856775814913674e16
YRSID_SI = 31_558_149.763545603

# (l, m) -> (k, r power, L power, C_re, C_im): the multipole family
# A_lmn = C_lm omega_mn^l F_n[r^rp L^lp e^{i k (phi - Omega_phi t)}], l <= 6
FAMILIES = {
    (2, 2): (2, 2, 0, -2.0 * np.sqrt(np.pi / 5.0), 0.0),
    (2, 0): (0, 2, 0, +np.sqrt(8.0 * np.pi / 15.0), 0.0),
    (2, 1): (1, 1, 1, 0.0, +np.sqrt(64.0 * np.pi / 45.0)),
    (3, 3): (3, 3, 0, 0.0, -np.sqrt(2.0 * np.pi / 189.0)),
    (3, 1): (1, 3, 0, 0.0, +np.sqrt(2.0 * np.pi / 315.0)),
    (3, 2): (2, 2, 1, -np.sqrt(np.pi / 63.0), 0.0),
    (3, 0): (0, 2, 1, +np.sqrt(2.0 * np.pi / 105.0), 0.0),
    (4, 4): (4, 4, 0, +np.sqrt(np.pi / 9072.0), 0.0),
    (4, 2): (2, 4, 0, -np.sqrt(np.pi / 15876.0), 0.0),
    (4, 0): (0, 4, 0, +np.sqrt(np.pi / 17640.0), 0.0),
    (4, 3): (3, 3, 1, 0.0, -np.sqrt(2.0 * np.pi / 14175.0)),
    (4, 1): (1, 3, 1, 0.0, +np.sqrt(2.0 * np.pi / 11025.0)),
    (5, 5): (5, 5, 0, 0.0, +np.sqrt(np.pi / 1188000.0)),
    (5, 3): (3, 5, 0, 0.0, -np.sqrt(np.pi / 2138400.0)),
    (5, 1): (1, 5, 0, 0.0, +np.sqrt(np.pi / 2494800.0)),
    (5, 4): (4, 4, 1, +np.sqrt(np.pi / 1069200.0), 0.0),
    (5, 2): (2, 4, 1, -np.sqrt(np.pi / 801900.0), 0.0),
    (5, 0): (0, 4, 1, +np.sqrt(np.pi / 748440.0), 0.0),
    (6, 6): (6, 6, 0, -np.sqrt(np.pi / 208494000.0), 0.0),
    (6, 4): (4, 6, 0, +np.sqrt(np.pi / 382239000.0), 0.0),
    (6, 2): (2, 6, 0, -np.sqrt(np.pi / 458686800.0), 0.0),
    (6, 0): (0, 6, 0, +8.0764808368e-05, 0.0),
    (6, 5): (5, 5, 1, 0.0, +np.sqrt(np.pi / 212837625.0)),
    (6, 3): (3, 5, 1, 0.0, -1.41873087857e-04),
    (6, 1): (1, 5, 1, 0.0, +1.49547365463e-04),
}

# rho_lm series at nu = 0 in x: (c1, c2, c3, c3 eulerlog, c4, c4 eulerlog,
# c5, c5 eulerlog); eulerlog_m(x) = gamma_E + ln 2m + ln(x) / 2
RHO = {
    (2, 2): (-43.0 / 42.0, -20555.0 / 10584.0, 1556919113.0 / 122245200.0, -428.0 / 105.0,
             -387216563023.0 / 160190110080.0, 9202.0 / 2205.0,
             -16094530514677.0 / 533967033600.0, 439877.0 / 55566.0),
    (2, 1): (-59.0 / 56.0, -47009.0 / 56448.0, 7613184941.0 / 2607897600.0, -107.0 / 105.0,
             0.0, 0.0, 0.0, 0.0),
    (3, 3): (-7.0 / 6.0, -6719.0 / 3960.0, 3203101567.0 / 227026800.0, -26.0 / 7.0,
             0.0, 0.0, 0.0, 0.0),
    (3, 1): (-13.0 / 18.0, 101.0 / 7128.0, 11706720301.0 / 6129723600.0, -26.0 / 63.0,
             0.0, 0.0, 0.0, 0.0),
    (3, 2): (-164.0 / 135.0,) + (0.0,) * 7,
    (4, 4): (-269.0 / 220.0,) + (0.0,) * 7,
    (4, 2): (-191.0 / 220.0,) + (0.0,) * 7,
    (4, 3): (-111.0 / 88.0,) + (0.0,) * 7,
    (4, 1): (-301.0 / 264.0,) + (0.0,) * 7,
    (5, 5): (-487.0 / 390.0,) + (0.0,) * 7,
}
# residual phase delta_lm = d1 x^{3/2} + pi d2 x^3
DELTA = {
    (2, 2): (7.0 / 3.0, 428.0 / 105.0),
    (2, 1): (2.0 / 3.0, 107.0 / 105.0),
    (3, 3): (13.0 / 10.0, 26.0 / 7.0),
    (3, 1): (13.0 / 30.0, 26.0 / 63.0),
    (4, 4): (14.0 / 15.0, 0.0),
    (4, 2): (7.0 / 15.0, 0.0),
}
X_MAX = 0.30  # the resummation is used below the light ring only
R_CLAMP = (0.15, 6.0)  # the band of |R| the eccentric calibration accepts
U_SHIFT = 0.5
N_CHI = 256  # Darwin-anomaly nodes of every orbit average
DELTA_P_STOP = 0.12


class Modes:
    """A static (l, m, n) list (m >= 0; the -m partners by symmetry)."""

    def __init__(self, ls, ms, ns):
        self.ls, self.ms, self.ns = (np.asarray(x, dtype=np.int64) for x in (ls, ms, ns))

    def __len__(self):
        return len(self.ls)

    def take(self, idx) -> "Modes":
        idx = np.asarray(idx)
        return Modes(self.ls[idx], self.ms[idx], self.ns[idx])

    def triples(self):
        return list(zip(self.ls.tolist(), self.ms.tolist(), self.ns.tolist()))


def mode_list(n_max: int, l_max: int) -> Modes:
    """Every family up to l_max: n in [-n_max, n_max], m = 0 with n >= 1."""
    if l_max > 6:
        raise ValueError("the reference carries the families up to l = 6")
    ls, ms, ns = [], [], []
    for (l, m) in FAMILIES:
        if l > l_max:
            continue
        for n in (range(1, n_max + 1) if m == 0 else range(-n_max, n_max + 1)):
            ls.append(l)
            ms.append(m)
            ns.append(n)
    return Modes(ls, ms, ns)


# ---------------------------------------------------------------- geodesic

def energy_angmom(p, e):
    d = p - 3.0 - e * e
    return np.sqrt(((p - 2.0) ** 2 - 4.0 * e * e) / (p * d)), p / np.sqrt(d)


def el_jacobian(p, e, h=1e-30):
    """d(E, L)/d(p, e) by complex steps: [[E_p, E_e], [L_p, L_e]]."""
    ep, lp = energy_angmom(p + 1j * h, e + 0j)
    ee, le = energy_angmom(p + 0j, e + 1j * h)
    return ep.imag / h, ee.imag / h, lp.imag / h, le.imag / h


def _orbit(p, e):
    """Darwin parametrisation on N_CHI nodes of chi (trailing axis)."""
    chi = 2.0 * np.pi * np.arange(N_CHI) / N_CHI
    p_, e_ = np.asarray(p) * 1.0, np.asarray(e) * 1.0
    p_, e_ = p_[..., None], e_[..., None]
    ec = e_ * np.cos(chi)
    sq = np.sqrt(p_ - 6.0 - 2.0 * ec)
    dphi = np.sqrt(p_) / sq
    dt = p_ ** 2 * np.sqrt((p_ - 2.0) ** 2 - 4.0 * e_ ** 2) / ((p_ - 2.0 - 2.0 * ec) * (1.0 + ec) ** 2 * sq)
    return chi, ec, dphi, dt


def frequencies(p, e):
    """(Omega_phi, Omega_r): the orbit averages of dphi/dchi and dt/dchi."""
    _, _, dphi, dt = _orbit(p, e)
    t_r = dt.mean(axis=-1)
    return dphi.mean(axis=-1) / t_r, 1.0 / t_r


def _periodic_integral(g):
    """The zero-mean antiderivative of a periodic g - mean(g) on the chi
    nodes, spectrally (FFT)."""
    n = g.shape[-1]
    c = np.fft.rfft(g - g.mean(axis=-1, keepdims=True), axis=-1)
    k = np.arange(c.shape[-1])
    c[..., 1:] /= 1j * k[1:]
    c[..., 0] = 0.0
    if n % 2 == 0:
        c[..., -1] = 0.0
    return np.fft.irfft(c, n=n, axis=-1)


def harmonics(p, e, fams, n_grid):
    """F_n[g] of each family (l, m) in ``fams`` for n in ``n_grid``: the
    average over one radial period of r^rp L^lp e^{i k (phi - Omega_phi t)}
    e^{-i n Omega_r t} (real by symmetry). ``p``, ``e``: (P,). Returns
    {family: (P, len(n_grid))}."""
    chi, ec, dphi, dt = _orbit(p, e)
    p_ = np.asarray(p, float)[..., None]
    t_mean = dt.mean(axis=-1, keepdims=True)
    om_phi = dphi.mean(axis=-1, keepdims=True) / t_mean
    t_per = _periodic_integral(dt)
    theta = chi + t_per / t_mean  # Omega_r t
    drift = _periodic_integral(dphi) - om_phi * t_per  # phi - Omega_phi t
    w = dt / dt.sum(axis=-1, keepdims=True)
    r = p_ / (1.0 + ec)
    ell = r * r * dphi / dt
    basis = np.exp(-1j * theta[..., None] * np.asarray(n_grid, float))  # (P, N_CHI, N)
    out = {}
    for fam in fams:
        k, rp, lp = FAMILIES[fam][:3]
        g = w * r ** rp * (ell if lp else 1.0) * np.exp(1j * k * drift)
        out[fam] = np.real(np.einsum("pc,pcn->pn", g, basis))
    return out


def mode_frequencies(p, e, modes: Modes):
    om_phi, om_r = frequencies(p, e)
    return modes.ms * om_phi[..., None] + modes.ns * om_r[..., None]


def _x_of(omega, ms):
    return np.minimum((np.abs(omega) / np.maximum(np.abs(ms), 1)) ** (2.0 / 3.0), X_MAX)


def _tail(ls, omega, r0=2.0):
    """Gamma(l + 1 - 2 i omega) / l! e^{pi omega} e^{2 i omega ln(2 |omega| r0)}."""
    lg = special.loggamma(ls + 1.0 - 2j * omega) - special.gammaln(ls + 1.0)
    return np.exp(lg + np.pi * omega + 2j * omega * np.log(2.0 * np.abs(omega) * r0))


def _resummation(modes: Modes, p, e, omega, with_phase=True):
    """S_hat rho_lm^l e^{i delta_lm sign(omega)}."""
    x = _x_of(omega, modes.ms)
    energy, angmom = energy_angmom(p, e)
    even = (modes.ls + np.abs(modes.ms)) % 2 == 0
    src = np.where(even, energy[..., None], (angmom / np.sqrt(p))[..., None])
    c = np.array([RHO.get((l, abs(m)), (0.0,) * 8) for l, m in zip(modes.ls, modes.ms)])
    elog = np.euler_gamma + np.log(2.0 * np.maximum(np.abs(modes.ms), 1)) + 0.5 * np.log(x)
    coef = [c[:, 0], c[:, 1], c[:, 2] + c[:, 3] * elog, c[:, 4] + c[:, 5] * elog,
            c[:, 6] + c[:, 7] * elog]
    rho = 1.0 + sum(ci * x ** (i + 1) for i, ci in enumerate(coef))
    out = src * rho ** modes.ls
    if not with_phase:
        return out
    d = np.array([DELTA.get((l, abs(m)), (0.0, 0.0)) for l, m in zip(modes.ls, modes.ms)])
    delta = d[:, 0] * x ** 1.5 + np.pi * d[:, 1] * x ** 3
    return out * np.exp(1j * delta * np.sign(omega))


def _keys(s):
    """The Keys / Catmull-Rom cardinal (a = -1/2)."""
    a = np.abs(s)
    return np.where(a < 1.0, (1.5 * a - 2.5) * a * a + 1.0,
                    np.where(a < 2.0, ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0, 0.0))


def _cardinal_weights(t, n):
    """Weights (..., n) of the 4-node Keys stencil at node coordinate t in
    [0, n - 1], the nodes past either edge replicating it."""
    t = np.clip(t, 0.0, n - 1.0)
    i = np.clip(np.floor(t), 0, n - 2)
    w = np.zeros(t.shape + (n,))
    for a in range(-1, 3):
        j = np.clip(i + a, 0, n - 1).astype(np.int64)
        np.put_along_axis(w, j[..., None],
                          np.take_along_axis(w, j[..., None], -1) + _keys(t - (i + a))[..., None], -1)
    return w


def _calibration(modes: Modes, p, e, omega):
    """B_lm(x_mn) R_lmn(u, e): the circular ratio on its log-x table and the
    complex eccentric residual on its (u, e) table, |R| clamped."""
    c = rwz_circular
    x = _x_of(omega, modes.ms)
    tx = (np.log(x) - np.log(c.X_LO)) / ((np.log(c.X_HI) - np.log(c.X_LO)) / (c.N_X - 1))
    rows = np.stack([c.B_TABLE.get((l, abs(m)), np.ones(c.N_X)) for l, m in zip(modes.ls, modes.ms)])
    b = np.einsum("...mj,mj->...m", _cardinal_weights(tx, c.N_X), rows)
    d = rwz_eccentric
    u = np.log(p - 6.0 - 2.0 * e + U_SHIFT)
    wu = _cardinal_weights((u - d.U0) / d.DU, d.N_U)  # (..., N_U)
    we = _cardinal_weights((e - d.E0) / d.DE, d.N_E)
    ones = np.ones((d.N_U, d.N_E), complex)
    tab = np.stack([d.R_TABLE.get((l, m, n), ones) for l, m, n in modes.triples()])  # (M, U, E)
    r = np.einsum("...u,...e,mue->...m", wu, we, tab)
    mag = np.abs(r)
    r = r * np.clip(mag, *R_CLAMP) / np.maximum(mag, 1e-300)
    return b * r


def amplitudes(p, e, modes: Modes, *, tail=True, factorized=True, rwz=True):
    """A_lmn(p, e), complex (P, M), for points ``p``, ``e`` (P,)."""
    p, e = np.atleast_1d(np.asarray(p, float)), np.atleast_1d(np.asarray(e, float))
    fams = sorted(set(zip(modes.ls.tolist(), modes.ms.tolist())))
    n_grid = np.unique(modes.ns)
    f_of = harmonics(p, e, fams, n_grid)
    col = {n: i for i, n in enumerate(n_grid.tolist())}
    f = np.stack([f_of[(l, m)][:, col[n]] for l, m, n in modes.triples()], axis=-1)
    omega = mode_frequencies(p, e, modes)
    c = np.array([complex(*FAMILIES[(l, m)][3:]) for l, m in zip(modes.ls, modes.ms)])
    a = c * omega ** modes.ls * f
    if tail:
        a = a * _tail(modes.ls, omega)
    if factorized:
        a = a * _resummation(modes, p, e, omega)
    if rwz:
        a = a * _calibration(modes, p, e, omega)
    return a


def flux_point(p, e, modes: Modes, *, tail=True, factorized=True, rwz=True):
    """(Edot, Ldot) / nu at points (P,): -(1/8 pi) sum omega^2 |A|^2 and
    -(1/8 pi) sum m omega |A|^2 over the modes (the -m partners double the
    m >= 0 half)."""
    p, e = np.atleast_1d(np.asarray(p, float)), np.atleast_1d(np.asarray(e, float))
    omega = mode_frequencies(p, e, modes)
    power = np.abs(amplitudes(p, e, modes, tail=False, factorized=False, rwz=False)) ** 2
    if tail:
        power = power * np.abs(_tail(modes.ls, omega)) ** 2
    if factorized:
        power = power * _resummation(modes, p, e, omega, with_phase=False) ** 2
    if rwz:
        power = power * np.abs(_calibration(modes, p, e, omega)) ** 2
    return (-(omega * omega * power).sum(-1) / (8.0 * np.pi),
            -(modes.ms * omega * power).sum(-1) / (8.0 * np.pi))


class FluxTable:
    """(Edot, Ldot) / nu on a regular (u, e) grid, u = ln(p - 6 - 2e + 1/2),
    read by the bicubic Catmull-Rom surface."""

    def __init__(self, values, u0, du, e0, de):
        self.values = np.asarray(values, dtype=np.float64)
        self.u0, self.du, self.e0, self.de = float(u0), float(du), float(e0), float(de)

    @classmethod
    def build(cls, physics: dict, n_u=96, n_e=49, e_range=(1e-6, 0.78), chunk=256):
        """The multipole flux of the l <= 6, |n| <= 30 harmonics at the rung
        ``physics`` names, on the model's grid."""
        us = np.linspace(np.log(U_SHIFT + 0.02), np.log(16.0), n_u)
        es = np.linspace(e_range[0], e_range[1], n_e)
        uu, ee = np.meshgrid(us, es, indexing="ij")
        pp = np.exp(uu) - U_SHIFT + 6.0 + 2.0 * ee
        modes = mode_list(30, 6)
        kw = dict(tail=physics["tail"], factorized=physics["factorized"], rwz=physics["rwz"])
        parts = max(1, pp.size // chunk)
        vals = [np.stack(flux_point(pc, ec, modes, **kw), -1)
                for pc, ec in zip(np.array_split(pp.ravel(), parts), np.array_split(ee.ravel(), parts))]
        return cls(np.concatenate(vals).reshape(n_u, n_e, 2), us[0], us[1] - us[0], es[0],
                   es[1] - es[0])

    def save(self, path):
        np.savez(path, values=self.values, axes=np.array([self.u0, self.du, self.e0, self.de]))

    @classmethod
    def load(cls, path):
        with np.load(path) as z:
            return cls(z["values"], *z["axes"].tolist())

    def __call__(self, p, e):
        u = math.log(p - 6.0 - 2.0 * e + U_SHIFT)
        fx, fy = (u - self.u0) / self.du, (e - self.e0) / self.de
        nx, ny = self.values.shape[:2]
        ix = min(max(math.floor(fx), 1), nx - 3)
        iy = min(max(math.floor(fy), 1), ny - 3)
        wx = _catmull_rom(min(max(fx - ix, -1.0), 2.0))
        wy = _catmull_rom(min(max(fy - iy, -1.0), 2.0))
        return wx @ np.einsum("abk,b->ak", self.values[ix - 1:ix + 3, iy - 1:iy + 3], wy)


def _catmull_rom(t):
    return np.array([((-0.5 * t + 1.0) * t - 0.5) * t, (1.5 * t - 2.5) * t * t + 1.0,
                     ((-1.5 * t + 2.0) * t + 0.5) * t, (0.5 * t - 0.5) * t * t])


# -------------------------------------------------------------- harmonics

def spin_weighted_ylm(ls, ms, theta, phi, s=-2):
    """sY_lm(theta, phi), complex, by the Wigner-d sum."""
    out = np.zeros(len(ls), complex)
    c, sn = math.cos(theta / 2.0), math.sin(theta / 2.0)
    for i, (l, m) in enumerate(zip(np.asarray(ls).tolist(), np.asarray(ms).tolist())):
        norm = (-1) ** m * math.sqrt((2 * l + 1) / (4.0 * math.pi) * math.factorial(l + m)
                                     * math.factorial(l - m) / (math.factorial(l + s)
                                                                * math.factorial(l - s)))
        acc = 0.0
        for r in range(max(0, m - s), min(l - s, l + m) + 1):
            acc += (math.comb(l - s, r) * math.comb(l + s, r + s - m) * (-1) ** (l - r - s)
                    * c ** (2 * r + s - m) * sn ** (2 * l - 2 * r - s + m))
        out[i] = norm * acc * complex(math.cos(m * phi), math.sin(m * phi))
    return out
