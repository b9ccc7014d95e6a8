"""Legacy MLDC-era LISA noise models.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.mldc``: the mission
configuration presets (`MLDCModel`, `mldc_model`), the MLDC ``lisanoises``
zoo, the Phinney confusion background, the sky-averaged `mldc_lisanoise` /
`mldc_simplesnr` pair, the white-dwarf confusion fits (`make_wd_noise`:
the 'mldc' piecewise curve and the rat42 / poly4 SNR-5 subtraction fits),
the synthlisa-normalization TDI X / AE / T PSDs, the Tobs-interpolated
galactic fit (`sgal`, `galconf`) and `simplesnr` against `lisasens`.

The mission configuration is a frozen dataclass passed explicitly. As in
`lisa.sensitivity`, numpy arrays and Python numbers compute in numpy
float64 and return numpy; tensors compute in float64 on their device and
return tensors there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .sensitivity import _xp

C_SI = 299_792_458.0


def _f64(f):
    return f.to(torch.float64) if isinstance(f, torch.Tensor) else f


_DEFAULT_L = 16.6782  # seconds (5e9 m nominal MLDC arm)
_DEFAULT_D = 0.4
_DEFAULT_P = 1.0


@dataclass(frozen=True)
class MLDCModel:
    """Immutable mission configuration.

    lisaL is the arm length in SECONDS (light travel time); lisaD the
    telescope diameter [m]; lisaP the laser power [W]; lisaWD the default
    white-dwarf confusion style for the legacy PSDs.
    """

    noisemodel: str = "lisareq"
    lisaL: float = _DEFAULT_L
    lisaD: float = _DEFAULT_D
    lisaP: float = _DEFAULT_P
    lisaWD: object = None

    @property
    def optscale(self) -> float:
        return (
            (self.lisaL / _DEFAULT_L) ** 2
            * (_DEFAULT_D / self.lisaD) ** 4
            * (_DEFAULT_P / self.lisaP)
        )


_PRESETS = {
    "lisa-classic": {},
    "default": {},
    "CLISA1_P005c_LPF": dict(noisemodel="newlpf", lisaL=1e9 / C_SI, lisaP=0.05),
    "10LISA1_P2_DRS": dict(noisemodel="newdrs-wrong", lisaL=1e9 / C_SI, lisaP=2.0),
    "10LISA1_P07_D25_DRS_4L": dict(noisemodel="newdrs", lisaL=1e9 / C_SI, lisaP=0.7, lisaD=0.25),
    "10LISA1_P2_D25_DRS_4L": dict(noisemodel="newdrs", lisaL=1e9 / C_SI, lisaP=2.0, lisaD=0.25),
    "10LISA1_P07_D25_RDRS_4L": dict(noisemodel="reddrs", lisaL=1e9 / C_SI, lisaP=0.7,
                                    lisaD=0.25),
    "lagrange": dict(noisemodel="wind", lisaL=21e9 / C_SI),
    "lagrange-smallmirror": dict(noisemodel="wind", lisaL=21e9 / C_SI, lisaD=0.2),
}
_BARE_NOISEMODELS = (
    "mldc", "mldc-nominal", "lisareq", "toy", "newlpf", "newdrs",
    "reddrs", "lpf", "wind", "ax50",
)


def mldc_model(name: str = "default", arm_m: float | None = None) -> MLDCModel:
    """A preset mission configuration by name (or a bare noise model's name).

    ``arm_m`` (meters) overrides the arm length unless the preset pins one.
    """
    base = MLDCModel()
    if arm_m is not None:
        base = replace(base, lisaL=arm_m / C_SI)
    if name in _PRESETS:
        return replace(base, **_PRESETS[name])
    if name in _BARE_NOISEMODELS:
        return replace(base, noisemodel=name)
    raise NotImplementedError(name)


def mldc_lisanoises(f, model: MLDCModel | None = None, noisemodel: str | None = None):
    """(Spm, Sop) in fractional-frequency units."""
    f = _f64(f)
    m = model or MLDCModel()
    nm = noisemodel or m.noisemodel
    lfac = (m.lisaL / _DEFAULT_L) ** 2
    if nm == "mldc":
        spm = 2.5e-48 * (1.0 + (f / 1.0e-4) ** -2) * f ** (-2)
        sop = 1.8e-37 * lfac * f**2
    elif nm == "mldc-nominal":
        spm = 2.53654e-48 * (1.0 + (f / 1.0e-4) ** -2) * f ** (-2)
        sop = 1.75703e-37 * lfac * f**2
    elif nm == "lisareq":
        spm = 2.53654e-48 * (1.0 + (f / 1.0e-4) ** -1) * (1.0 + (f / 0.008) ** 4) * f ** (-2)
        sop = 1.42319e-37 * lfac * (1.0 + (f / 0.002) ** -4) * f**2
    elif nm == "toy":
        spm = 2.53654e-48 * f ** (-2)
        sop = (1.1245e-37 * m.optscale + 6.3253e-38) * f**2
    elif nm == "newlpf":
        spm = 8.17047e-48 * (1.0 + (f / 1.8e-4) ** -1) ** 2 * f ** (-2)
        sop = (6.15e-38 * m.optscale + 2.81e-38) * f**2
    elif nm == "newdrs-wrong":
        spm = 6.00314e-48 * f ** (-2)
        sop = (3.07e-38 * m.optscale + 2.81e-38) * f**2
    elif nm == "newdrs":
        spm = 6.00314e-48 * f ** (-2)
        sop = (6.15e-38 * m.optscale + 2.81e-38) * f**2
    elif nm == "reddrs":
        spm = 6.0e-48 * (1.0 + (1e-4 / f)) * f ** (-2)
        sop = (6.17e-38 * m.optscale + 2.76e-38) * f**2
    elif nm == "lpf":
        spm = (
            1.86208e-47
            * (1.0 + (f / 10**-3.58822) ** -1.79173)
            * (1.0 + (f / 10**-2.21652) ** 3.74838)
            * f ** (-2)
        )
        sop = (1.16502e-38 + 2.60435e-38 * lfac) * f**2
    elif nm == "wind":
        spm = 1.76e-50 * f**-0.75 * f ** (-2)
        sop = 1.42319e-37 * lfac * (1.0 + (f / 0.002) ** -4) * f**2
    elif nm == "windnew":
        spm = 1.76e-50 / 12 * f**-0.75 * f ** (-2)
        sop = 1.42319e-37 * m.optscale * (1.0 + (f / 0.002) ** -4) * f**2
    elif nm == "ax50":
        spm = 50 * 2.53654e-48 * (1.0 + (f / 1.0e-4) ** -1) * (1.0 + (f / 0.008) ** 4) * f ** (-2)
        sop = 1.42319e-37 * lfac * (1.0 + (f / 0.002) ** -4) * f**2
    else:
        raise NotImplementedError(nm)
    return spm, sop


def phinney_switch(s_inst, s_gwdb, switch):
    return _xp(s_inst).minimum(s_inst * switch, s_inst + s_gwdb)


@dataclass(frozen=True)
class PhinneyBackground:
    """Unresolved-binary background with a source-density resolvability
    switch: S_gwdb ~ Sh f^Sh_exp, and the factor exp(k/T dN/df) inflates the
    instrument noise where more than ~koverT binaries share a bin."""

    Sh: float = 1.4e-44
    dNdf: float = 2e-3
    koverT: float = 1.5
    Sh_exp: float = -7.0 / 3.0
    dNdf_exp: float = -11.0 / 3.0

    def __call__(self, f, s_inst=None):
        f = _f64(f)
        xp = _xp(f)
        s_gwdb = self.Sh * f**self.Sh_exp
        dndf = self.dNdf * f**self.dNdf_exp
        kt = self.koverT / (365.25 * 24 * 3600)
        if s_inst is None:
            return s_gwdb
        # exponent capped: beyond ~700 the multiplicative branch overflows
        # float64, and the switch's min() already takes the additive branch
        return phinney_switch(s_inst, s_gwdb, xp.exp(xp.minimum(kt * dndf, 700.0)))


_WDNOISE = {
    # SNR-5 subtraction fits between 1e-4 and 5e-3 Hz (X) / 4e-4 (AET);
    # (model, params) per (X, AE) channel
    "tau2": (
        ("rat42", [-1.2503, -13.3508, -94.1852, -296.6416, -313.8596, 4.9418, 6.1323]),
        ("rat42", [-1.2599, -13.8309, -97.7703, -311.5419, -336.4092, 5.0691, 6.4637]),
    ),
    "opt": (
        ("rat42", [-1.0865, -11.2113, -83.9764, -271.5378, -287.9153, 4.8456, 5.8931]),
        ("rat42", [-1.0781, -11.3477, -85.3638, -279.6701, -301.9440, 4.9496, 6.1504]),
    ),
    "pess": (
        ("rat42", [-1.2649, -13.5895, -95.5196, -301.0872, -319.7566, 4.9740, 6.2117]),
        ("rat42", [-1.2813, -14.1556, -99.5091, -316.7877, -342.7881, 5.1004, 6.5392]),
    ),
    "hybrid": (
        ("poly4", [-2.4460, -33.4121, -171.5341, -390.7209, -373.5341]),
        ("poly4", [-2.7569, -38.0938, -197.8030, -455.9119, -433.8260]),
    ),
}


def make_wd_noise(f, wdstyle, obs: str = "X", model: MLDCModel | None = None):
    """White-dwarf confusion PSD added to the legacy TDI curves: the 'mldc'
    piecewise power law, a fit of ``_WDNOISE``, or a two-column text table
    (a path containing ".txt")."""
    f = _f64(f)
    m = model or MLDCModel()
    xp = _xp(f)
    if wdstyle == "mldc":
        x = 2.0 * math.pi * m.lisaL * f
        t = 4 * x**2 * xp.sin(x) ** 2 * (1.0 if obs == "X" else 1.5)
        segs = [
            (1.0e-4, 1.0e-3, 10**-44.62, -2.3),
            (1.0e-3, 10**-2.7, 10**-50.92, -4.4),
            (10**-2.7, 10**-2.4, 10**-62.8, -8.8),
            (10**-2.4, 10**-2.0, 10**-89.68, -20.0),
        ]
        acc = xp.zeros_like(f)
        for lo, hi, amp, expo in segs:
            acc = acc + xp.where((f >= lo) & (f < hi), amp * f**expo, 0.0)
        return t * acc
    if wdstyle in _WDNOISE:
        mod, p = _WDNOISE[wdstyle][0 if obs == "X" else 1]
        y = xp.log10(f)
        if mod == "rat42":
            return 10.0 ** (
                (p[0] * y**4 + p[1] * y**3 + p[2] * y**2 + p[3] * y + p[4])
                / (y**2 + p[5] * y + p[6])
            )
        return 10.0 ** (p[0] * y**4 + p[1] * y**3 + p[2] * y**2 + p[3] * y + p[4])
    if isinstance(wdstyle, str) and ".txt" in wdstyle:
        conf = np.loadtxt(wdstyle)
        conf[np.isnan(conf[:, 1]), 1] = 0
        if isinstance(f, torch.Tensor):
            return torch.as_tensor(np.interp(f.cpu().numpy(), conf[:, 0], conf[:, 1]),
                                   device=f.device)
        return np.interp(np.asarray(f), conf[:, 0], conf[:, 1])
    raise NotImplementedError(wdstyle)


def sgal(fr, pars):
    """Parametric galactic-confusion shape."""
    fr = _f64(fr)
    xp = _xp(fr)
    amp, alpha, sl1, kn, sl2 = pars
    return (
        amp
        * xp.exp(-(fr**alpha) * sl1)
        * fr ** (-7.0 / 3.0)
        * 0.5
        * (1.0 + xp.tanh(xp.clip(-(fr - kn) * sl2, -20.0, 20.0)))
    )


_GC_DAY = 86400.0
_GC_MONTH = _GC_DAY * 30.5
_GC_YEAR = 365.25 * 24.0 * 3600.0
_GC_XOBS = np.array(
    [1.0 * _GC_DAY, 3.0 * _GC_MONTH, 6.0 * _GC_MONTH, 1.0 * _GC_YEAR,
     2.0 * _GC_YEAR, 4.0 * _GC_YEAR, 10.0 * _GC_YEAR]
)
_GC_SLOPE1 = np.array(
    [9.41315118e02, 1.36887568e03, 1.68729474e03, 1.76327234e03,
     2.32678814e03, 3.01430978e03, 3.74970124e03]
)
_GC_KNEE = np.array(
    [1.15120924e-02, 4.01884128e-03, 3.47302482e-03, 2.77606177e-03,
     2.41178384e-03, 2.09278117e-03, 1.57362626e-03]
)
_GC_SLOPE2 = np.array(
    [1.03239773e02, 1.03351646e03, 1.62204855e03, 1.68631844e03,
     2.06821665e03, 2.95774596e03, 3.15199454e03]
)


def galconf(fr, t_obs_s: float):
    """The MLDC galactic confusion at observation time ``t_obs_s``: `sgal`
    with its shape parameters linearly interpolated in Tobs over the 7-point
    table (flat below 1 day; no extrapolation beyond 10 yr)."""
    if t_obs_s > 10.0 * _GC_YEAR:
        raise ValueError(f"no extrapolation beyond 10 yr (Tobs={t_obs_s:g} s)")
    sl1 = float(np.interp(t_obs_s, _GC_XOBS, _GC_SLOPE1))
    kn = float(np.interp(t_obs_s, _GC_XOBS, _GC_KNEE))
    sl2 = float(np.interp(t_obs_s, _GC_XOBS, _GC_SLOPE2))
    return sgal(fr, [3.26651613e-44, 1.18300266e00, sl1, kn, sl2])


def wd_confusion_x_mldc(f, duration_years: float, model: MLDCModel | None = None):
    """`galconf` projected onto TDI X."""
    f = _f64(f)
    m = model or MLDCModel()
    if duration_years < _GC_DAY / _GC_YEAR or duration_years > 10.0:
        raise ValueError("duration outside [1 day, 10 yr]")
    xp = _xp(f)
    x = 2.0 * math.pi * m.lisaL * f
    return 4.0 * x**2 * xp.sin(x) ** 2 * galconf(f, duration_years * _GC_YEAR)


def wd_confusion_ae_mldc(f, duration_years: float, model: MLDCModel | None = None):
    return 1.5 * wd_confusion_x_mldc(f, duration_years, model)


def mldc_lisanoise(f, model: MLDCModel | None = None, includewd=None):
    """Sky-averaged strain sensitivity S_h(f).

    ``includewd``: None | 'cutler' | a PhinneyBackground | a `make_wd_noise`
    style ('mldc', 'tau2', ...). The 'cutler' noise model is the
    Barack-Cutler Eq. 25 curve with the 20/3 signal-averaging factor.
    """
    f = _f64(f)
    m = model or MLDCModel()
    nm = m.noisemodel
    xp = _xp(f)
    if includewd is None:
        includewd = m.lisaWD

    if nm == "cutler":
        sh = (20.0 / 3.0) * (9.18e-52 * f**-4 + 1.59e-41 + 9.18e-38 * f**2)
        if includewd is True:
            return PhinneyBackground()(f, sh)
        if includewd is None:
            return sh
        raise NotImplementedError(includewd)

    # math.sqrt where the argument is a number (the same IEEE sqrt as numpy's)
    if nm == "lisareq":
        sa = 3e-15 * xp.sqrt(1.0 + (f / 1.0e-4) ** -1) * xp.sqrt(1.0 + (f / 0.008) ** 4)
        so = 18e-12 * m.optscale * xp.sqrt(1 + (f / 0.002) ** -4)
    elif nm == "lpf":
        sa = 10**-14.09 * xp.sqrt(
            (1.0 + (f / 10**-3.58822) ** -1.79173) * (1.0 + (f / 10**-2.21652) ** 3.74838)
        )
        so = math.sqrt((7.7e-12) ** 2 * m.optscale + (5.15e-12) ** 2)
    elif nm == "toy":
        sa = 3e-15
        so = math.sqrt((1.6e-11) ** 2 * m.optscale + (1.2e-11) ** 2)
    elif nm == "newtoy":
        sa = 3e-15
        so = 2e-11
    elif nm == "newlpf":
        sa = 5.3e-15 * (1.0 + (f / 1.8e-4) ** -1)
        so = math.sqrt((1.18e-11) ** 2 * m.optscale + (8.0e-12) ** 2)
    elif nm == "newdrs-wrong":
        sa = 4.6e-15
        so = math.sqrt((8.36e-12) ** 2 * m.optscale + (8.0e-12) ** 2)
    elif nm == "newdrs":
        sa = 4.6e-15
        so = math.sqrt((1.18e-11) ** 2 * m.optscale + (8.0e-12) ** 2)
    elif nm == "wind":
        sa = 2.5e-16 * f**-0.75
        so = 18e-12 * m.optscale * xp.sqrt(1 + (f / 0.002) ** -4)
    elif nm == "windnew":
        sa = 2.5e-16 / 3.464 * f**-0.75
        so = 18e-12 * m.optscale * xp.sqrt(1 + (f / 0.002) ** -4)
    elif nm == "ax50":
        sa = 50 * 3e-15 * xp.sqrt(1.0 + (f / 1.0e-4) ** -1) * xp.sqrt(1.0 + (f / 0.008) ** 4)
        so = 18e-12 * m.optscale * xp.sqrt(1 + (f / 0.002) ** -4)
    else:
        raise NotImplementedError(nm)

    sac = sa * 2.0 / (2.0 * math.pi * f) ** 2
    arm_m = m.lisaL * C_SI
    ft = 0.5 / m.lisaL
    t2 = 1.0 + (f / (0.41 * ft)) ** 2

    if includewd is None:
        swd = 0.0
    elif includewd == "cutler":
        return PhinneyBackground()(f, (20.0 / 3.0) * t2 * (sac**2 + so**2) / arm_m**2)
    elif isinstance(includewd, PhinneyBackground):
        return includewd(f, (20.0 / 3.0) * t2 * (sac**2 + so**2) / arm_m**2)
    else:
        x = 2.0 * math.pi * m.lisaL * f
        swd = (
            make_wd_noise(f, includewd, obs="X", model=m)
            * arm_m**2
            / (16.0 * xp.sin(x) ** 2 * x**2)
        )
    return (20.0 / 3.0) * t2 * (sac**2 + so**2 + swd) / arm_m**2


def _inclination_factor(i):
    if i is None:
        return math.sqrt(16.0 / 5.0)
    xi = _xp(i)
    return xi.sqrt((1 + xi.cos(i) ** 2) ** 2 + (2.0 * xi.cos(i)) ** 2)


def mldc_simplesnr(f, h, i=None, years: float = 1.0,
                   model: MLDCModel | None = None, includewd=None):
    """Sky- and inclination-averaged SNR of a monochromatic source (face-on
    factor from the inclination ``i`` when given)."""
    f = _f64(f)
    xp = _xp(f)
    h0 = h * _inclination_factor(i)
    return h0 * math.sqrt(years * 365.25 * 24 * 3600) / xp.sqrt(
        mldc_lisanoise(f, model, includewd)
    )


def simplesnr(f, h, i=None, years: float = 1.0, noisemodel: str = "SciRDv1",
              includewd=None):
    """`mldc_simplesnr` against `lisasens` (``includewd``: the confusion's
    observation time in years, or None for none)."""
    from .sensitivity import lisasens

    f = _f64(f)
    xp = _xp(f)
    h0 = h * _inclination_factor(i)
    sens = lisasens(
        f, noisemodel,
        t_obs_years=includewd if includewd is not None else 4.0,
        include_confusion=includewd is not None,
    )
    return h0 * math.sqrt(years * 365.25 * 24 * 3600) / xp.sqrt(sens)


def mldc_noisepsd_X(f, model: MLDCModel | None = None, includewd=None):
    """TDI X PSD, synthlisa normalization."""
    f = _f64(f)
    m = model or MLDCModel()
    if includewd is None:
        includewd = m.lisaWD
    xp = _xp(f)
    x = 2.0 * math.pi * m.lisaL * f
    spm, sop = mldc_lisanoises(f, m)
    sx = 16.0 * xp.sin(x) ** 2 * (2.0 * (1.0 + xp.cos(x) ** 2) * spm + sop)
    if includewd is not None:
        sx = sx + make_wd_noise(f, includewd, "X", m)
    return sx


def mldc_noisepsd_AE(f, model: MLDCModel | None = None, includewd=None):
    """TDI A / E PSD, synthlisa normalization."""
    f = _f64(f)
    m = model or MLDCModel()
    if includewd is None:
        includewd = m.lisaWD
    xp = _xp(f)
    x = 2.0 * math.pi * m.lisaL * f
    spm, sop = mldc_lisanoises(f, m)
    sa = 8.0 * xp.sin(x) ** 2 * (
        2.0 * spm * (3.0 + 2.0 * xp.cos(x) + xp.cos(2 * x)) + sop * (2.0 + xp.cos(x))
    )
    if includewd is not None:
        sa = sa + make_wd_noise(f, includewd, "AE", m)
    return sa


def mldc_noisepsd_T(f, model: MLDCModel | None = None):
    """TDI T PSD, synthlisa normalization."""
    f = _f64(f)
    m = model or MLDCModel()
    xp = _xp(f)
    x = 2.0 * math.pi * m.lisaL * f
    spm, sop = mldc_lisanoises(f, m)
    return (
        16.0 * sop * (1.0 - xp.cos(x)) * xp.sin(x) ** 2
        + 128.0 * spm * xp.sin(x) ** 2 * xp.sin(0.5 * x) ** 4
    )


__all__ = [
    "MLDCModel",
    "PhinneyBackground",
    "galconf",
    "make_wd_noise",
    "mldc_lisanoise",
    "mldc_lisanoises",
    "mldc_model",
    "mldc_noisepsd_AE",
    "mldc_noisepsd_T",
    "mldc_noisepsd_X",
    "mldc_simplesnr",
    "phinney_switch",
    "sgal",
    "simplesnr",
    "wd_confusion_ae_mldc",
    "wd_confusion_x_mldc",
]
