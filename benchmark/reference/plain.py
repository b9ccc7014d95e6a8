"""The plain reference of the benchmark's cells, in NumPy and SciPy alone.

It works out again, from the configuration and the model's data, all that
the program's set-up derives (the shared window offsets, the injection and
its whitening), then what the timed path
produced: the spectra of given walkers, a PE template and its log L. It
imports nothing of the program and runs none of its code: the trajectory is
SciPy's DOP853 (`trajectory`), the model is written from its equations
(`physics`), the spectra are the bin-by-bin stationary-phase sum (`spa`).
Shared with the program are the model's data only: the flux table
(`flux_table`) and the frozen harmonics (`harmonics`), which the
configuration names and the benchmark hands to both sides.

The control (``phase_dtype=np.float32``) is the reference with the
trajectory's orbital phases rounded to float32 where they are produced,
the precision below the configuration's float64 trajectory.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import physics as ph
from . import spa
from .trajectory import Inspiral

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def physics(cfg: dict) -> dict:
    """The trajectory flux and the amplitude rungs of a configuration."""
    phys = cfg["physics"]
    return dict(flux=phys["flux"], tail=bool(phys["tail"]),
                factorized=bool(phys["factorized"]), rwz=bool(phys["rwz"]))


def flux_table(cfg: dict) -> ph.FluxTable:
    """The configuration's multipole flux table (the model's data, handed
    to the program as well)."""
    return ph.FluxTable.load(os.path.join(ROOT, cfg["flux_table"]))


def harmonics(cfg: dict) -> ph.Modes:
    """The configuration's frozen harmonics, in its order."""
    return ph.Modes(*np.asarray(cfg["harmonics"], dtype=np.int64).T)


def positive_grid(t_years: float, dt: float, downsample: int = 1) -> tuple[float, float, int]:
    """(f0, df, nf) of the positive FFT frequencies of the odd-length grid
    of ``t_years`` at ``dt``, every ``downsample``-th kept."""
    n = int(t_years * ph.YRSID_SI / dt)
    n += 1 - n % 2
    step = max(int(downsample), 1)
    df1 = 1.0 / (n * dt)
    nf = ((n - 1) // 2 + step - 1) // step
    return df1, df1 * step, nf


def dist_factor(mu, dist_gpc):
    return mu * ph.MRSUN_SI / (dist_gpc * ph.GPC_SI)


class WaveformBatchReference:
    """The all-mode FD spectra of a `wf_batch` cell: the configuration's
    harmonics, each kept to its window of ``band_runs`` runs of
    ``bins_per_run`` bins from its start frequency at the representative
    source (less an eighth of the window), the falling branches of the
    first ``turnover_slots`` to theirs."""

    def __init__(self, cfg: dict, phase_dtype=np.float64):
        self.cfg, self.phase_dtype = cfg, phase_dtype
        self.phys = physics(cfg)
        self.flux = flux_table(cfg)
        self.f0, self.df, self.nf = positive_grid(cfg["t_years"], cfg["dt"])
        src = cfg["representative_source"]
        insp = self.inspiral(src["p0"], src["e0"])
        self.modes = harmonics(cfg)
        f_start = np.array([insp.mode(m, n)[0][0] for m, n in zip(self.modes.ms, self.modes.ns)])
        r, runs = cfg["bins_per_run"], cfg["band_runs"]
        g0 = np.floor((f_start - self.f0) / (r * self.df)).astype(np.int64) - int(runs * 0.125)
        self.offsets = np.maximum(g0, 0)
        self.windows = [(g * r, (g + runs) * r) for g in self.offsets]
        self.turnover = (cfg["turnover_slots"], (0, cfg["extra_band_runs"] * r))

    def inspiral(self, p0, e0) -> Inspiral:
        cfg = self.cfg
        return Inspiral(self.flux, cfg["mass_1"], cfg["mass_2"], p0, e0, cfg["t_years"],
                        phase_dtype=self.phase_dtype)

    def spectra(self, row) -> np.ndarray:
        """(p0, e0, theta, phi) -> (4, nf) float64: h+ re, im, hx re, im."""
        p0, e0, theta, phi = (float(x) for x in row)
        hp, hc = spa.source_spectra(
            self.inspiral(p0, e0), self.modes, self.phys, theta, phi,
            dist_factor(self.cfg["mass_2"], self.cfg["dist"]), self.f0, self.df, self.nf,
            windows=self.windows, turnover=self.turnover)
        return np.stack([hp.real, hp.imag, hc.real, hc.imag])


def lisa_psd(f, t_obs_years=1.0):
    """Sky-averaged LISA sensitivity with the galactic foreground
    (Robson, Cornish & Liu 2019, arXiv:1803.01944 eqs. 1, 10-14)."""
    arm = 2.5e9
    f_star = ph.C_SI / (2.0 * math.pi * arm)
    p_oms = (1.5e-11) ** 2 * (1.0 + (2e-3 / f) ** 4)
    p_acc = (3e-15) ** 2 * (1.0 + (0.4e-3 / f) ** 2) * (1.0 + (f / 8e-3) ** 4)
    pn = (p_oms + 2.0 * (1.0 + np.cos(f / f_star) ** 2) * p_acc / (2.0 * math.pi * f) ** 4) / arm ** 2
    sn = 10.0 / 3.0 * pn * (1.0 + 0.6 * (f / f_star) ** 2)
    fits = {0.5: (0.133, 243.0, 482.0, 917.0, 2.58e-3),
            1.0: (0.171, 292.0, 1020.0, 1680.0, 2.15e-3),
            2.0: (0.165, 299.0, 611.0, 1340.0, 1.73e-3),
            4.0: (0.138, -221.0, 521.0, 1680.0, 1.13e-3)}
    alpha, beta, kappa, gamma, fk = fits[min(fits, key=lambda k: abs(k - t_obs_years))]
    conf = (9e-45 * f ** (-7.0 / 3.0) * np.exp(-(f ** alpha) + beta * f * np.sin(kappa * f))
            * (1.0 + np.tanh(np.clip(gamma * (fk - f), -20.0, 20.0))))
    return sn + conf


class PEReference:
    """The PE template and whitened log L of a `pe_sampler` cell: p0 as the
    configuration fixes it, the configuration's harmonics, the FD injection
    on the downsampled positive grid whitened by the LISA PSD; log L =
    -1/2 * 4 * sum |d - h|^2 df / S over both channels."""

    def __init__(self, cfg: dict, phase_dtype=np.float64):
        if cfg["sens_fn"] != "cornish_lisa_psd":
            raise ValueError(f"no reference for the PSD {cfg['sens_fn']!r}")
        self.cfg, self.phase_dtype = cfg, phase_dtype
        self.phys = physics(cfg)
        self.flux = flux_table(cfg)
        self.f0, self.df, self.nf = positive_grid(cfg["Tobs"], cfg["dt"], cfg["downsample"])
        self.modes = harmonics(cfg)
        f = self.f0 + self.df * np.arange(self.nf)
        self.white = np.sqrt(self.df / lisa_psd(f))
        self.data_w = self.template(self.truth()[None])[0] * self.white

    def truth(self) -> np.ndarray:
        c, inj = self.cfg, self.cfg["injection"]
        return np.array([np.log(c["M"]), np.log(c["mu"] / c["M"]), c["p0"], c["e0"],
                         inj["Phi_phi0"], inj["Phi_r0"]])

    def inspiral(self, x) -> Inspiral:
        m = math.exp(x[0])
        return Inspiral(self.flux, m, m * math.exp(x[1]), x[2], x[3], self.cfg["Tobs"],
                        phi_phi0=x[4], phi_r0=x[5], phase_dtype=self.phase_dtype)

    def template(self, xs) -> np.ndarray:
        """(n, 6) sampled rows (ln M, ln(mu / M), p0, e0, Phi_phi0, Phi_r0)
        -> (n, 4, nf) float64 template channels."""
        inj, out = self.cfg["injection"], []
        for x in np.asarray(xs, dtype=np.float64):
            mu = math.exp(x[0] + x[1])
            hp, hc = spa.source_spectra(self.inspiral(x), self.modes, self.phys, inj["qS"],
                                        inj["phiS"], dist_factor(mu, inj["dist"]), self.f0,
                                        self.df, self.nf)
            out.append(np.stack([hp.real, hp.imag, hc.real, hc.imag]))
        return np.stack(out)

    def loglike(self, templates, data=None) -> np.ndarray:
        """(n, 4, nf) templates -> (n,) log L against the injection (or
        ``data``, (4, nf) channels)."""
        d = self.data_w if data is None else np.asarray(data, dtype=np.float64) * self.white
        r = d[None] - np.asarray(templates, dtype=np.float64) * self.white
        return -2.0 * np.sum(r * r, axis=(1, 2))


def lane_rel_l2(got, ref) -> np.ndarray:
    """(n,): per row, the worst channel's ||got - ref|| / ||ref|| of (n, 4,
    nf) spectra."""
    g, r = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    num = np.linalg.norm(g - r, axis=-1)
    den = np.maximum(np.linalg.norm(r, axis=-1), math.ldexp(1.0, -1000))
    return (num / den).max(axis=-1)


def strongest_harmonics(cfg: dict, mass_1, mass_2, p0, e0, theta, phi, t_years, k_max,
                        phi_phi0=0.0, phi_r0=0.0) -> list:
    """The k_max harmonics of the l <= l_max, |n| <= n_max list with the
    most time-averaged power along the source's trajectory (the frozen
    selection the configurations name), [l, m, n] in order of their start
    frequencies."""
    modes = ph.mode_list(cfg["n_max"], cfg["l_max"])
    insp = Inspiral(flux_table(cfg), mass_1, mass_2, p0, e0, t_years, phi_phi0, phi_r0)
    idx = spa.strongest(spa.mode_power(insp, modes, physics(cfg), theta, phi), k_max)
    top = modes.take(idx)
    start = [insp.mode(m, n)[0][0] for m, n in zip(top.ms, top.ns)]
    return [list(top.triples()[i]) for i in np.argsort(start, kind="stable")]
