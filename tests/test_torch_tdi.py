"""The PyTorch port's TDI container and MLDC noise models against the JAX
package, on the CPU.

`TDIf`: both constructors and the AET / XYZ round trip, the algebra, every
reduction and the channel PSDs on the same seeded channels, within 1e-12
relative (mirrors tests/test_lisa.py::TestTDIf). `lisa.mldc`: every preset,
every noise model and every function, numpy input against the JAX package's
numpy path within 1e-12 relative, and tensor input against numpy input
within 1e-12 relative, 2e-11 for the white-dwarf fits (FIT_TENSOR_RTOL)
(mirrors tests/test_mldc.py).
"""

import math

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu.lisa import mldc as j_mldc
from emri_frequencydomainwaveforms_tpu.lisa.tdi import TDIf as JTDIf
from emri_frequencydomainwaveforms_tpu_torch.lisa import mldc as t_mldc
from emri_frequencydomainwaveforms_tpu_torch.lisa.tdi import TDIf

RTOL = 1e-12
# tensor vs numpy input for the white-dwarf fits (10 to a polynomial, or a
# ratio of polynomials, of log10 f): torch's and numpy's pow differ in the
# last bit for ~6 % of inputs, the fit's terms (~1e3) cancel to an exponent
# of ~-40, and 10^x turns the exponent's error into a relative one; the
# rat42 ratio's denominator also nearly vanishes near 3 mHz (measured at
# most 5.3e-12 on this grid)
FIT_TENSOR_RTOL = 2e-11
FITS = ("tau2", "opt", "pess", "hybrid")


def _close(got, ref, rtol=RTOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=0)


def _channels(seed, n=64):
    rng = np.random.default_rng(seed)
    f = np.linspace(1e-3, 1e-2, n)
    return f, [rng.standard_normal(n) + 1j * rng.standard_normal(n) for _ in range(3)]


def _jc(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _same(t, j):
    """Every channel of the port's triple against the JAX one."""
    for name in ("X", "Y", "Z", "A", "E", "T"):
        _close(getattr(t, name), _jc(getattr(j, name)))


def test_constructors_and_round_trip():
    f, (X, Y, Z) = _channels(0)
    t, j = TDIf.from_xyz(f, X, Y, Z, device="cpu"), JTDIf.from_xyz(f, X, Y, Z)
    _same(t, j)
    assert t.A.dtype == torch.complex128 and t.f.dtype == torch.float64 and len(t) == 64
    # from_aet inverts the map, and takes (re, im) pairs and tensors
    t2 = TDIf.from_aet(f, t.Af, (t.Ef.real, t.Ef.imag), torch.from_numpy(t.Tf))
    j2 = JTDIf.from_aet(f, j.Af, j.Ef, j.Tf)
    _same(t2, j2)
    np.testing.assert_allclose(t2.Xf, X, atol=1e-12)
    np.testing.assert_allclose(t2.Y.numpy(), Y, atol=1e-12)
    # a number channel broadcasts to the others' shape
    t3 = TDIf.from_aet(f, X, Y, 0, device="cpu")
    assert t3.T.shape == (64,) and not t3.Tf.any()
    _same(t3, JTDIf.from_aet(f, X, Y, 0))


def test_device_is_required_without_tensors(monkeypatch):
    # numpy input runs on the current CUDA device unless a device is named:
    # with no card it raises, it does not fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, (X, Y, Z) = _channels(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDIf.from_xyz(f, X, Y, Z)
    assert TDIf.from_xyz(torch.from_numpy(f), X, Y, Z).f.device.type == "cpu"


def test_algebra():
    f, (X, Y, Z) = _channels(1)
    a_t, b_t = TDIf.from_xyz(f, X, Y, Z, device="cpu"), TDIf.from_xyz(f, 2 * X, -Y, 0.5 * Z,
                                                                        device="cpu")
    a_j, b_j = JTDIf.from_xyz(f, X, Y, Z), JTDIf.from_xyz(f, 2 * X, -Y, 0.5 * Z)
    w = np.linspace(0.5, 2.0, 64)
    for got, ref in ((a_t + b_t, a_j + b_j), (a_t - b_t, a_j - b_j), (a_t * b_t, a_j * b_j),
                     (a_t / b_t, a_j / b_j), (2.0 * a_t, 2.0 * a_j), (a_t * 3.0, a_j * 3.0),
                     (a_t / 4.0, a_j / 4.0), (a_t * w, a_j * w)):
        _same(got, ref)
    # with a number, + and - are complex arithmetic (the JAX package's
    # (re, im) pairs add the number to both parts)
    np.testing.assert_allclose((a_t + 2.0).Xf, X + 2.0, rtol=RTOL)
    np.testing.assert_allclose((a_t - 1.5).Af, a_t.Af - 1.5, rtol=RTOL)


def test_reductions_and_psds():
    f, (X, Y, Z) = _channels(2)
    d_t, d_j = TDIf.from_xyz(f, X, Y, Z, device="cpu"), JTDIf.from_xyz(f, X, Y, Z)
    h_t = TDIf.from_xyz(f, 0.9 * X, 0.8 * Y, 0.9 * Z, device="cpu")
    h_j = JTDIf.from_xyz(f, 0.9 * X, 0.8 * Y, 0.9 * Z)
    for name in ("Sae", "St", "Sx", "Sxy"):
        _close(getattr(d_t, name), getattr(d_j, name))
    _close(d_t.df, d_j.df)
    _close(d_t.normsq(), d_j.normsq())
    extra = (1e-41, 2e-41, 3e-41)
    _close(d_t.normsq(extranoise=extra), d_j.normsq(extranoise=extra))
    psd = (d_j.Sae, 2 * d_j.Sae, d_j.St)
    _close(d_t.normsq(noisepsd=psd), d_j.normsq(noisepsd=psd))
    _close(d_t.normsqx(), d_j.normsqx())
    _close(d_t.normsqx(noisepsd=2 * d_j.Sx), d_j.normsqx(noisepsd=2 * d_j.Sx))
    for got, ref in zip(d_t.cprod(h_t), d_j.cprod(h_j)):
        _close(got, ref)
    _close(d_t.dotprod(h_t), d_j.dotprod(h_j))
    _close(d_t.dotprodx(h_t), d_j.dotprodx(h_j))
    _close(d_t.logL(h_t), d_j.logL(h_j))
    # <d, d> is the norm, and log L of a triple against itself is exactly 0
    _close(d_t.dotprod(d_t), d_t.normsq(), rtol=1e-14)
    assert float(d_t.logL(d_t)) == 0.0
    # a one-bin triple has df = 1
    one = TDIf.from_xyz(f[:1], X[:1], Y[:1], Z[:1], device="cpu")
    assert float(one.df) == 1.0 and float(JTDIf.from_xyz(f[:1], X[:1], Y[:1], Z[:1]).df) == 1.0


# ---- lisa.mldc ----

F = np.geomspace(1e-5, 5e-2, 200)
PRESETS = ["lisa-classic", "default", "CLISA1_P005c_LPF", "10LISA1_P2_DRS",
           "10LISA1_P07_D25_DRS_4L", "10LISA1_P2_D25_DRS_4L", "10LISA1_P07_D25_RDRS_4L",
           "lagrange", "lagrange-smallmirror", "mldc", "mldc-nominal", "lisareq", "toy",
           "newlpf", "newdrs", "reddrs", "lpf", "wind", "ax50"]
NOISEMODELS = ["mldc", "mldc-nominal", "lisareq", "toy", "newlpf", "newdrs-wrong", "newdrs",
               "reddrs", "lpf", "wind", "windnew", "ax50"]
LISANOISE_MODELS = ["lisareq", "lpf", "toy", "newtoy", "newlpf", "newdrs-wrong", "newdrs", "wind",
                    "windnew", "ax50", "cutler"]


def _both(fn_t, fn_j, tensor_rtol=RTOL):
    """numpy input against the JAX package; a float64 tensor against numpy."""
    got, ref = fn_t(F), fn_j(F)
    out = fn_t(torch.from_numpy(F))
    if isinstance(ref, tuple):
        for g, r, o in zip(got, ref, out):
            assert isinstance(g, np.ndarray) and isinstance(o, torch.Tensor)
            _close(g, r)
            _close(o, g, tensor_rtol)
        return
    assert isinstance(got, np.ndarray) and isinstance(out, torch.Tensor)
    assert out.dtype == torch.float64
    _close(got, ref)
    _close(out, got, tensor_rtol)


def _both_tail(fn_t, fn_j, envelope):
    """`_both` for the galactic fits, whose 0.5 (1 + tanh) cut-off cancels
    to ~1e-16 of its envelope above the knee: torch's tanh and numpy's
    differ in the last bit there, so the tensor path is held to 1e-12
    relative plus 4e-16 of the envelope (the fit with the cut-off at 1)."""
    got, ref = fn_t(F), fn_j(F)
    _close(got, ref)
    out = fn_t(torch.from_numpy(F)).numpy()
    assert np.all(np.abs(out - got) <= RTOL * np.abs(got) + 4e-16 * envelope)


def _galactic_envelope(amp, alpha, sl1):
    # sgal with sl2 = 0 has the cut-off at 1/2
    return 2.0 * j_mldc.sgal(F, [amp, alpha, sl1, 0.0, 0.0])


def _models(name):
    return t_mldc.mldc_model(name), j_mldc.mldc_model(name)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_and_tdi_psds(name):
    mt, mj = _models(name)
    assert mt.__dict__ == mj.__dict__ and mt.optscale == mj.optscale
    assert t_mldc.mldc_model(name, arm_m=5e9) == t_mldc.MLDCModel(
        **j_mldc.mldc_model(name, arm_m=5e9).__dict__)
    _both(lambda f: t_mldc.mldc_noisepsd_X(f, mt), lambda f: j_mldc.mldc_noisepsd_X(f, mj))
    _both(lambda f: t_mldc.mldc_noisepsd_AE(f, mt), lambda f: j_mldc.mldc_noisepsd_AE(f, mj))
    _both(lambda f: t_mldc.mldc_noisepsd_T(f, mt), lambda f: j_mldc.mldc_noisepsd_T(f, mj))
    with pytest.raises(dataclasses_frozen()):
        mt.lisaL = 1.0


def dataclasses_frozen():
    from dataclasses import FrozenInstanceError

    return FrozenInstanceError


def test_unknown_preset_and_model_raise():
    with pytest.raises(NotImplementedError):
        t_mldc.mldc_model("no-such-mission")
    with pytest.raises(NotImplementedError):
        t_mldc.mldc_lisanoises(F, noisemodel="no-such-model")


@pytest.mark.parametrize("nm", NOISEMODELS)
def test_lisanoises(nm):
    _both(lambda f: t_mldc.mldc_lisanoises(f, noisemodel=nm),
          lambda f: j_mldc.mldc_lisanoises(f, noisemodel=nm))


@pytest.mark.parametrize("nm", LISANOISE_MODELS)
def test_lisanoise_and_simplesnr(nm):
    mt, mj = t_mldc.MLDCModel(noisemodel=nm), j_mldc.MLDCModel(noisemodel=nm)
    wds = [None, True] if nm == "cutler" else [None, "cutler", "mldc", "tau2", "opt", "pess",
                                                "hybrid"]
    for wd in wds:
        _both(lambda f: t_mldc.mldc_lisanoise(f, mt, includewd=wd),
              lambda f: j_mldc.mldc_lisanoise(f, mj, includewd=wd),
              FIT_TENSOR_RTOL if wd in FITS else RTOL)
    if nm != "cutler":
        _both(lambda f: t_mldc.mldc_lisanoise(f, mt, includewd=t_mldc.PhinneyBackground()),
              lambda f: j_mldc.mldc_lisanoise(f, mj, includewd=j_mldc.PhinneyBackground()))
    for i in (None, 0.0, 1.1):
        _both(lambda f: t_mldc.mldc_simplesnr(f, 1e-21, i=i, years=2.0, model=mt),
              lambda f: j_mldc.mldc_simplesnr(f, 1e-21, i=i, years=2.0, model=mj))


def test_wd_noise_galconf_phinney_and_simplesnr(tmp_path):
    for style in ("mldc", "tau2", "opt", "pess", "hybrid"):
        for obs in ("X", "AE"):
            _both(lambda f: t_mldc.make_wd_noise(f, style, obs),
                  lambda f: j_mldc.make_wd_noise(f, style, obs),
                  FIT_TENSOR_RTOL if style in FITS else RTOL)
    table = tmp_path / "conf.txt"
    np.savetxt(table, np.stack([np.geomspace(1e-5, 1e-1, 50), np.geomspace(1e-40, 1e-45, 50)], 1))
    _both(lambda f: t_mldc.make_wd_noise(f, str(table)),
          lambda f: j_mldc.make_wd_noise(f, str(table)))
    year = 365.25 * 24 * 3600.0
    x = 2.0 * math.pi * t_mldc.MLDCModel().lisaL * F
    for t_obs in (3600.0, 0.3 * year, 1.0 * year, 7.5 * year):
        env = _galactic_envelope(3.26651613e-44, 1.18300266,
                                 np.interp(t_obs, j_mldc._GC_XOBS, j_mldc._GC_SLOPE1))
        _both_tail(lambda f: t_mldc.galconf(f, t_obs), lambda f: j_mldc.galconf(f, t_obs), env)
        yrs = t_obs / year
        if t_obs < 86400.0:
            with pytest.raises(ValueError):
                t_mldc.wd_confusion_x_mldc(F, yrs)
            continue
        _both_tail(lambda f: t_mldc.wd_confusion_x_mldc(f, yrs),
                   lambda f: j_mldc.wd_confusion_x_mldc(f, yrs), 4.0 * x**2 * np.sin(x) ** 2 * env)
        _both_tail(lambda f: t_mldc.wd_confusion_ae_mldc(f, yrs),
                   lambda f: j_mldc.wd_confusion_ae_mldc(f, yrs), 6.0 * x**2 * np.sin(x) ** 2 * env)
    with pytest.raises(ValueError):
        t_mldc.galconf(F, 11.0 * year)
    pars = [3e-44, 1.2, 1500.0, 3e-3, 1700.0]
    _both_tail(lambda f: t_mldc.sgal(f, pars), lambda f: j_mldc.sgal(f, pars),
               _galactic_envelope(*pars[:3]))
    pb_t, pb_j = t_mldc.PhinneyBackground(), j_mldc.PhinneyBackground()
    _both(lambda f: pb_t(f), lambda f: pb_j(f))
    s_inst = np.full(F.shape, 1e-41)
    _close(pb_t(F, s_inst), pb_j(F, s_inst))
    _close(pb_t(torch.from_numpy(F), torch.from_numpy(s_inst)), pb_j(F, s_inst))
    for wd in (None, 1.0, 4.0):
        for i in (None, 0.7):
            _both(lambda f: t_mldc.simplesnr(f, 1e-21, i=i, years=3.0, includewd=wd),
                  lambda f: j_mldc.simplesnr(f, 1e-21, i=i, years=3.0, includewd=wd))
    # a number in, a number out, as in the reference
    assert math.isclose(t_mldc.mldc_simplesnr(3e-3, 1e-21), j_mldc.mldc_simplesnr(3e-3, 1e-21),
                        rel_tol=RTOL)
