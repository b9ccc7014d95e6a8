"""The PyTorch port's reference-signature facades, Kerr geodesics, utility
functions and Bessel functions, against the JAX package.

Each case runs the JAX function and its port on the same inputs (the cases
of tests/test_geodesic_generic.py, tests/test_trajectory.py's Kerr and
facade tests, tests/test_ops.py's interpolant and Bessel tests and
tests/test_amplitude.py's Ylm facade), then the reference test's own
identity on the port's values at the reference test's tolerance.

Tolerances. float64 geodesics, separatrices and routing: 1e-12 relative
(the Newton solves and quadratures run the same counts; measured <= 1e-14).
Ylm, splines, Bessel functions: 1e-13. Amplitudes: 2e-6 of the largest
requested amplitude (float32 projections summed in a different order).
"""

import numpy as np
import pytest
import scipy.special
import torch
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import geodesic as j_geo
from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu.models import modeselect as j_sel
from emri_frequencydomainwaveforms_tpu.models import utility as j_util
from emri_frequencydomainwaveforms_tpu.ops import bessel as j_bes
from emri_frequencydomainwaveforms_tpu.ops import cubic_spline as j_cs
from emri_frequencydomainwaveforms_tpu.utils import ylm as j_ylm
from emri_frequencydomainwaveforms_tpu_torch import models as t_models
from emri_frequencydomainwaveforms_tpu_torch import ops as t_ops
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude as t_amp
from emri_frequencydomainwaveforms_tpu_torch.models import flux as t_flux
from emri_frequencydomainwaveforms_tpu_torch.models import geodesic as t_geo
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from emri_frequencydomainwaveforms_tpu_torch.models import modeselect as t_sel
from emri_frequencydomainwaveforms_tpu_torch.models import utility as t_util
from emri_frequencydomainwaveforms_tpu_torch.ops import bessel as t_bes
from emri_frequencydomainwaveforms_tpu_torch.ops import cubic_spline as t_cs
from emri_frequencydomainwaveforms_tpu_torch.utils import ylm as t_ylm


def _close(ref, got, rtol=1e-12):
    for a, b in zip(ref, got):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=0)


# ------------------------------------------------------------ Kerr geodesics


@pytest.mark.parametrize("a,p,e", [(0.5, 9.0, 0.3), (0.9, 7.0, 0.1)])
@pytest.mark.parametrize("x", [1.0, -1.0])
def test_equatorial_limit(a, p, e, x):
    gen = t_geo.fundamental_frequencies_kerr_generic(a, p, e, x, device="cpu")
    eq = t_geo.fundamental_frequencies_kerr(a, p, e, x, device="cpu")
    _close(j_geo.fundamental_frequencies_kerr_generic(a, p, e, x), gen)
    _close(j_geo.fundamental_frequencies_kerr(a, p, e, x), eq)
    _close(eq, gen, rtol=1e-9)


@pytest.mark.parametrize("x", [0.3, -0.62, 0.9])
def test_schwarzschild_inclined(x):
    p, e = 9.0, 0.25
    op, ot, orr = t_geo.fundamental_frequencies_kerr_generic(0.0, p, e, x, device="cpu")
    _close(j_geo.fundamental_frequencies_kerr_generic(0.0, p, e, x), (op, ot, orr))
    np.testing.assert_allclose(op.numpy(), np.sign(x) * ot.numpy(), rtol=1e-12)
    op_pl, or_pl = t_geo.fundamental_frequencies(*(torch.tensor(v, dtype=torch.float64)
                                                   for v in (p, e)))
    np.testing.assert_allclose(orr.numpy(), or_pl.numpy(), rtol=1e-9)
    np.testing.assert_allclose(ot.numpy(), op_pl.numpy(), rtol=1e-9)


def test_constants_match_turning_points():
    a, p, e, x = 0.7, 8.0, 0.35, 0.55
    got = t_geo.kerr_gen_constants(a, p, e, x, device="cpu")
    _close(j_geo.kerr_gen_constants(a, p, e, x), got)
    en, lz, q = (float(v) for v in got)

    def big_r(r):
        delta = r * r - 2.0 * r + a * a
        t = en * (r * r + a * a) - a * lz
        return t * t - delta * (r * r + (lz - a * en) ** 2 + q)

    r_p, r_a = p / (1 + e), p / (1 - e)
    scale = big_r(0.5 * (r_p + r_a))
    assert abs(big_r(r_p) / scale) < 1e-10 and abs(big_r(r_a) / scale) < 1e-10
    z_m = 1.0 - x * x
    theta_pot = q - lz * lz * z_m / (1.0 - z_m) - a * a * (1 - en * en) * z_m
    assert abs(theta_pot) < 1e-10 * max(q, 1.0)


def test_separatrix_generic_matches_equatorial():
    a, e = 0.6, 0.3
    ps_eq = t_geo.separatrix_kerr(a, e, 1.0, device="cpu")
    ps_gen = t_geo.separatrix_kerr_generic(a, e, 0.9999999, device="cpu")
    _close([j_geo.separatrix_kerr(a, e, 1.0), j_geo.separatrix_kerr_generic(a, e, 0.9999999)],
           [ps_eq, ps_gen])
    np.testing.assert_allclose(float(ps_gen), float(ps_eq), atol=2e-4)


def test_separatrix_monotone_in_inclination():
    a, e = 0.7, 0.2
    xs = torch.tensor([0.95, 0.5, 0.1, -0.5, -0.95], dtype=torch.float64)
    ps = t_geo.separatrix_kerr_generic(a, e, xs, device="cpu")  # elementwise over x
    _close([j_geo.separatrix_kerr_generic(a, e, xs.numpy())], [ps])
    assert bool((torch.diff(ps) > 0).all()), ps


def test_kerr_equatorial_closed_forms():
    # tests/test_trajectory.py::TestKerrGeodesic, each on the port's values
    p, e = 9.3, 0.41
    op, ot, orr = t_geo.fundamental_frequencies_kerr(0.0, p, e, device="cpu")
    op0, or0 = t_geo.fundamental_frequencies(*(torch.tensor(v, dtype=torch.float64)
                                               for v in (p, e)))
    np.testing.assert_allclose([float(op), float(orr), float(ot)],
                               [float(op0), float(or0), float(op)], rtol=1e-13)
    r = 8.0
    a = torch.tensor([0.3, 0.7, 0.95], dtype=torch.float64)
    op, ot, orr = t_geo.fundamental_frequencies_kerr(a, r, 1e-10, device="cpu")
    _close(j_geo.fundamental_frequencies_kerr(a.numpy(), r, 1e-10), (op, ot, orr))
    a = a.numpy()
    om = 1.0 / (r**1.5 + a)
    np.testing.assert_allclose(op.numpy(), om, rtol=1e-9)
    np.testing.assert_allclose(ot.numpy(), om * np.sqrt(1 - 4 * a / r**1.5 + 3 * a**2 / r**2),
                               rtol=1e-8)
    np.testing.assert_allclose(
        orr.numpy(), om * np.sqrt(1 - 6 / r + 8 * a / r**1.5 - 3 * a**2 / r**2), rtol=1e-7)
    op_retro, _, _ = t_geo.fundamental_frequencies_kerr(0.5, 9.0, 1e-10, x=-1.0, device="cpu")
    np.testing.assert_allclose(float(op_retro), -1.0 / (9.0**1.5 - 0.5), rtol=1e-9)
    ek, lk = t_geo.kerr_eq_energy_angmom(0.0, 10.0, 0.3, device="cpu")
    es, ls = t_geo.energy_angmom(*(torch.tensor(v, dtype=torch.float64) for v in (10.0, 0.3)))
    np.testing.assert_allclose([float(ek), float(lk)], [float(es), float(ls)], rtol=1e-12)
    _close(j_geo.kerr_eq_energy_angmom(0.6, 9.0, 0.2),
           t_geo.kerr_eq_energy_angmom(0.6, 9.0, 0.2, device="cpu"))


def test_separatrix_kerr_isco_and_schwarzschild():
    for a, x in ((0.5, 1.0), (0.9, 1.0), (0.7, -1.0)):
        z1 = 1 + (1 - a * a) ** (1 / 3) * ((1 + a) ** (1 / 3) + (1 - a) ** (1 / 3))
        z2 = np.sqrt(3 * a * a + z1 * z1)
        risco = 3 + z2 - np.sign(x) * np.sqrt((3 - z1) * (3 + z1 + 2 * z2))
        ps = t_geo.separatrix_kerr(a, 1e-8, x=x, device="cpu")
        _close([j_geo.separatrix_kerr(a, 1e-8, x=x)], [ps])
        np.testing.assert_allclose(float(ps), risco, rtol=1e-6)
    e = torch.tensor([0.0, 0.3, 0.7], dtype=torch.float64)
    np.testing.assert_allclose(t_geo.separatrix_kerr(0.0, e).numpy(), 6.0 + 2.0 * e.numpy(),
                               atol=1e-10)


# ------------------------------------------------------------ utility.py


@pytest.mark.parametrize("a,p,e,x", [(0.0, 9.0, 0.3, 1.0), (0.0, 9.0, 0.3, -1.0),
                                     (0.6, 7.0, 0.2, 1.0), (0.5, 9.0, 0.3, 0.7)],
                         ids=["schwarzschild", "schwarzschild-retro", "equatorial", "generic"])
def test_utility_frequencies_and_separatrix(a, p, e, x):
    got = t_util.get_fundamental_frequencies(a, p, e, x, device="cpu")
    assert all(np.isfinite(v).all() for v in got)
    _close(j_util.get_fundamental_frequencies(a, p, e, x), got)
    ps = t_util.get_separatrix(a, e, x, device="cpu")
    _close([j_util.get_separatrix(a, e, x)], [ps])
    if a == 0.6:  # tests/test_trajectory.py::test_utility_facade_kerr
        assert got[0] > 0 and got[2] > 0 and 2.0 < float(ps) < 6.0
    if x == 0.7:  # tests/test_geodesic_generic.py::test_facade_routes_generic
        assert 4.0 < float(ps) < 9.0


def test_utility_overlap_and_mismatch():
    rng = np.random.default_rng(61)
    a = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    b = a + 0.1 * (rng.standard_normal(300) + 1j * rng.standard_normal(300))
    for fn in ("get_overlap", "get_mismatch"):
        assert getattr(t_util, fn)(a, b[:280]) == getattr(j_util, fn)(a, b[:280])


@pytest.mark.parametrize("fn", ["get_p_at_t", "get_mu_at_t"])
def test_utility_duration_solves_route_as_reference(fn, monkeypatch):
    # the list-style wrappers hand the duration solve the reference's
    # arguments (the solves themselves are held against the reference in
    # tests/test_torch_rwz.py and tests/test_torch_pe.py)
    seen = {}

    def record(name):
        def solve(*args, **kw):
            seen[name] = (args, {k: v for k, v in kw.items() if k != "device"})
            return torch.tensor([7.5], dtype=torch.float64) if name == "torch" else 7.5
        return solve

    monkeypatch.setattr(t_util._inspiral, fn, record("torch"))
    monkeypatch.setattr(j_util._inspiral, fn, record("jax"))
    traj_args = [1e6, 10.0, 0.0, 0.35, 1.0] if fn == "get_p_at_t" else [1e6, 0.0, 12.0, 0.35, 1.0]
    kw = {"bounds": (8.0, 15.0)} if fn == "get_p_at_t" else {}
    got = getattr(t_util, fn)(None, 0.5, traj_args, device="cpu", **kw)
    assert got == getattr(j_util, fn)(None, 0.5, traj_args, **kw) == 7.5
    assert seen["torch"] == seen["jax"]


def test_cuda_set_device_and_sanity_check(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    t_util.cuda_set_device(1)
    assert calls == [1]
    j_guard, t_guard = j_util.SchwarzschildEccentric(), t_util.SchwarzschildEccentric()
    assert t_guard.sanity_check_init(1e6, 10.0, 12.0, 0.35) is True
    assert t_guard.sanity_check_angles(0.5, 1.0, 2.0, 3.0) is True
    for bad in ((1e6, 1e4, 12.0, 0.35), (1e6, 10.0, 12.0, 0.8), (1e6, 10.0, 6.75, 0.35),
                (-1.0, 10.0, 12.0, 0.35)):
        for guard in (j_guard, t_guard):
            with pytest.raises(ValueError):
                guard.sanity_check_init(*bad)


# ------------------------------------------------------------ class facades


def test_emri_inspiral_facade():
    traj = t_insp.EMRIInspiral(func="SchwarzEccFlux", max_steps=256, device="cpu")
    out = traj(1e6, 10.0, 0.0, 12.0, 0.35, 1.0, T=0.1)
    ref = j_insp.EMRIInspiral(func="SchwarzEccFlux", max_steps=256)(1e6, 10.0, 0.0, 12.0, 0.35,
                                                                   1.0, T=0.1)
    full = t_insp.schwarz_ecc_flux_inspiral(1e6, 10.0, 12.0, 0.35, t_years=0.1, max_steps=256,
                                            device="cpu")
    n = int(full.n[0])
    assert len(out) == 7 and all(o.shape == (n,) for o in out)
    for o, name in zip(out, ("t", "p", "e", "x", "Phi_phi", "Phi_theta", "Phi_r")):
        assert torch.equal(o, getattr(full, name)[0, :n])
    assert float(out[3][0]) == 1.0 and float(out[5][-1]) == 0.0
    # the same integration as the reference's (PM flux agrees to ~1e-12)
    assert out[0].shape == ref[0].shape
    _close([ref[0][-1], ref[4][-1]], [out[0][-1], out[4][-1]], rtol=1e-9)
    with pytest.raises(NotImplementedError):
        t_insp.EMRIInspiral(func="KerrEccentricEquatorial")


def test_inspiral_rhs_params():
    nu = 1e-5
    state = torch.tensor([[10.0, 0.3, 0.0, 0.0]], dtype=torch.float64)
    bare = t_flux.inspiral_rhs(state, nu)
    params = t_flux.InspiralRHS(nu=torch.tensor(nu, dtype=torch.float64))
    wrapped = t_flux.inspiral_rhs(state, params)
    assert torch.equal(bare, wrapped)


def test_newtonian_amplitude_facade():
    p = np.array([10.0, 12.5])
    e = np.array([0.3, 0.45])
    modes = [(2, 2, 1), (2, -2, -1), (3, 1, 0), (3, -1, 2), (4, 4, -3)]
    ref = j_amp.NewtonianAmplitude()(jnp.asarray(p), jnp.asarray(e), specific_modes=modes)
    got = t_amp.NewtonianAmplitude(device="cpu")(p, e, specific_modes=modes)
    assert list(got) == modes
    scale = max(np.abs(v).max() for v in ref.values())
    for lmn in modes:
        assert np.iscomplexobj(got[lmn]) and got[lmn].shape == (2,)
        assert np.abs(got[lmn] - ref[lmn]).max() <= 2e-6 * scale, lmn
    # the symmetry partner: A_{l,-m,-n} = (-1)^l conj(A_{l,m,n})
    np.testing.assert_allclose(got[(2, -2, -1)], np.conj(got[(2, 2, 1)]), rtol=1e-15)
    full_ref = j_amp.NewtonianAmplitude()(jnp.asarray(p), jnp.asarray(e), n_max=3)
    full = t_amp.NewtonianAmplitude(device="cpu")(p, e, n_max=3)
    assert list(full) == list(full_ref)
    scale = max(np.abs(v).max() for v in full_ref.values())
    assert max(np.abs(full[k] - full_ref[k]).max() for k in full) <= 2e-6 * scale


def test_mode_selector_facade():
    rng = np.random.default_rng(62)
    table = j_amp.default_mode_table(4, l_max=3)
    m = table.ls.size
    a_re, a_im = rng.standard_normal((2, 30, m))
    y = rng.standard_normal((4, m))
    ref = j_sel.ModeSelector(table, k_max=12)(*(jnp.asarray(v) for v in (a_re, a_im, *y)), eps=1e-2)
    got = t_sel.ModeSelector(t_amp.ModeTable(*table), k_max=12)(
        *(torch.from_numpy(v) for v in (a_re, a_im, *y)), eps=1e-2)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), rtol=1e-13)


@pytest.mark.parametrize("positive", [True, False])
def test_get_ylms_facade(positive):
    ls, ms = np.array([2, 3, 4]), np.array([2, 1, 0])
    if not positive:
        ms = np.array([2, -1, -3])
    ref = j_ylm.GetYlms(assume_positive_m=positive)(ls, ms, 0.5, 0.4)
    got = t_ylm.GetYlms(assume_positive_m=positive, device="cpu")(ls, ms, 0.5, 0.4)
    assert got.shape == ref.shape == ((6,) if positive else (3,)) and np.iscomplexobj(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-13)
    if positive:  # tests/test_amplitude.py::test_reference_facade
        direct = t_ylm.GetYlms(device="cpu")(np.array([2, 2]), np.array([2, -2]), 0.5, 0.4)
        np.testing.assert_allclose(got[[0, 3]], direct, rtol=1e-13)


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_cubic_spline_interpolant_facade(bc):
    t = np.linspace(0, 1, 30)
    y = np.stack([np.sin(5 * t), np.cos(5 * t)])
    t_new = np.linspace(0, 1, 100)
    for yy in (y, y[0]):
        ref = j_cs.CubicSplineInterpolant(t, yy, bc=bc)
        got = t_cs.CubicSplineInterpolant(t, yy, bc=bc, device="cpu")
        for deriv in (0, 1, 2):
            out = got(t_new, deriv=deriv)
            assert out.shape == yy.shape[:-1] + (100,)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref(t_new, deriv=deriv)),
                                       rtol=1e-13, atol=1e-13)
    out = t_cs.CubicSplineInterpolant(t, y, device="cpu")(t_new).numpy()
    np.testing.assert_allclose(out[0], np.sin(5 * t_new), atol=2e-3)


# ------------------------------------------------------------ Bessel functions


def test_kve_one_third():
    mags = np.concatenate([np.linspace(0.01, 8, 60), np.logspace(1, 4, 20)])
    for sign in (+1.0, -1.0):
        z = sign * 1j * mags
        got = t_bes.kve_one_third(torch.from_numpy(z))
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), np.asarray(j_bes.kve_one_third(jnp.asarray(z))),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(got.numpy(), scipy.special.kv(1.0 / 3.0, z) * np.exp(z),
                                   rtol=1e-7, atol=1e-12)
    x = np.concatenate([np.linspace(0.05, 5, 40), np.linspace(10, 30, 20)])
    got = t_bes.kve_one_third(torch.from_numpy(x))  # float64 -> complex128
    np.testing.assert_allclose(got.numpy().real, scipy.special.kve(1.0 / 3.0, x), rtol=1e-6)
    z32 = torch.from_numpy((1j * mags).astype(np.complex64))
    assert t_bes.kve_one_third(z32).dtype == torch.complex64
    # numpy and Python input on a named device computes in complex128
    assert torch.equal(t_bes.kve_one_third(x, device="cpu"), got)
    one = t_bes.kve_one_third(2.0, device="cpu")
    assert one.dtype == torch.complex128
    np.testing.assert_allclose(one.numpy().real, scipy.special.kve(1.0 / 3.0, 2.0), rtol=1e-12)


def test_bessel_jn():
    x = np.array([0.0, 0.3, 1.7, 5.2, 11.0])
    got = t_bes.bessel_jn(8, torch.from_numpy(x))
    assert got.shape == (9, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_bes.bessel_jn(8, jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)
    for n in range(9):
        np.testing.assert_allclose(got[n].numpy(), scipy.special.jv(n, x), atol=1e-10)
    # numpy and Python input on a named device computes in float64
    assert torch.equal(t_bes.bessel_jn(8, x, device="cpu"), got)
    one = t_bes.bessel_jn(8, 1.7, device="cpu")
    assert one.dtype == torch.float64
    np.testing.assert_allclose(one.numpy(), got[:, 2].numpy(), rtol=1e-15)


def test_package_exports_match_reference():
    # the JAX package's models/ and ops/ exports, all of them
    from emri_frequencydomainwaveforms_tpu import models as j_models
    from emri_frequencydomainwaveforms_tpu import ops as j_ops

    assert set(t_models.__all__) == set(j_models.__all__)
    assert set(t_ops.__all__) == set(j_ops.__all__)
    assert all(hasattr(t_models, n) for n in t_models.__all__)
    assert all(hasattr(t_ops, n) for n in t_ops.__all__)


# The JAX package's exports of inference/, lisa/ and utils/ that the port
# does not have yet, each with the ROADMAP Queue 1 item that ports it: none
# left.
NOT_YET_PORTED = {
    "inference": {},
    "lisa": {},
    "utils": {},
}


@pytest.mark.parametrize("package", sorted(NOT_YET_PORTED))
def test_subpackage_exports_match_reference(package):
    import importlib

    ref = importlib.import_module(f"emri_frequencydomainwaveforms_tpu.{package}")
    got = importlib.import_module(f"emri_frequencydomainwaveforms_tpu_torch.{package}")
    later = set(NOT_YET_PORTED[package])
    assert later <= set(ref.__all__)
    assert set(got.__all__) == set(ref.__all__) - later
    assert all(hasattr(got, n) for n in got.__all__)
    assert not any(hasattr(got, n) for n in later)
