"""Parity of the PyTorch port's production (rwz) physics with the JAX package.

Seeded numpy inputs go through each JAX function and its counterpart in the
port, on the CPU: the bicubic interpolation, the tail factor, the factorized
resummation, the rwz calibration tables and their evaluation, the amplitude
rungs, the multipole flux and its grid, the trajectory over the multipole
flux and the frozen rwz batch end to end.

Tolerances. float64 stages: 1e-12 to 1e-13 relative. The calibration tables
are evaluated in float32 in both packages (a dense contraction there, a
4-point gather here): 2e-6. Amplitudes are float32 projections summed in
different orders: 2e-6 of each family's largest coefficient at that orbit.
Each package's own flux-grid build therefore carries float32 noise (1e-6 to
1e-4, growing with eccentricity; see `_E_QUIET`), which a year of inspiral
amplifies; so every comparison that
integrates a trajectory interpolates the reference's grid, carried across by
`convert.flux_grid_from_numpy`. That grid is built once per process (module
fixture), which is why all tests that need it live in this file.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import _rwz_calibration_data as j_bdata
from emri_frequencydomainwaveforms_tpu.models import _rwz_ecc_data as j_rdata
from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import amplitude_backends as j_back
from emri_frequencydomainwaveforms_tpu.models import flux as j_flux
from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu.models import rho as j_rho
from emri_frequencydomainwaveforms_tpu.models import rwz_calibration as j_rwz
from emri_frequencydomainwaveforms_tpu.models import tail as j_tail
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.ops import interp2d as j_interp
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_calibration_data as t_bdata
from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_ecc_data as t_rdata
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude as t_amp
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude_backends as t_back
from emri_frequencydomainwaveforms_tpu_torch.models import flux as t_flux
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from emri_frequencydomainwaveforms_tpu_torch.models import rho as t_rho
from emri_frequencydomainwaveforms_tpu_torch.models import rwz_calibration as t_rwz
from emri_frequencydomainwaveforms_tpu_torch.models import tail as t_tail
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.ops import interp2d as t_interp
from emri_frequencydomainwaveforms_tpu_torch.ops.cubic_spline import (
    fit_cubic_spline,
    spline_eval,
)

RUNGS = {
    "tail": dict(tail=True),
    "tail_r0": dict(tail=True, tail_r0=3.5),
    "factorized": dict(factorized=True),
    "tail_factorized": dict(tail=True, factorized=True),
    "rwz": dict(tail=True, factorized=True, rwz=True),
}
RWZ = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def orbits():
    rng = np.random.default_rng(51)
    e = rng.uniform(0.02, 0.6, (2, 6))
    p = 6.0 + 2.0 * e + rng.uniform(0.15, 9.0, (2, 6))
    return p, e


@pytest.fixture(scope="module")
def small_table():
    """A slice of the l <= 6 table: every l, both parities, m = 0 modes (no
    B row) and |n| beyond the eccentric table (no R row)."""
    lmn = [(2, 2, n) for n in range(-3, 6)] + [(2, 1, n) for n in (-1, 0, 1, 2)]
    lmn += [(2, 0, 1), (2, 0, 2), (3, 3, -1), (3, 3, 0), (3, 3, 1), (3, 3, 2), (3, 2, 0), (3, 2, 1)]
    lmn += [(3, 1, 1), (3, 0, 1), (4, 4, 0), (4, 4, 1), (4, 3, 1), (4, 2, 1), (4, 1, 2), (4, 0, 1)]
    lmn += [(5, 5, 0), (5, 5, 1), (5, 4, 1), (5, 2, 1), (5, 0, 2), (6, 6, 0), (6, 6, 1), (6, 5, 1)]
    lmn += [(6, 3, 2), (6, 0, 1), (2, 2, 13), (3, 3, -5), (4, 4, 14)]
    ls, ms, ns = (np.array(x) for x in zip(*lmn))
    return j_amp.ModeTable(ls, ms, ns), t_amp.ModeTable(ls, ms, ns)


@pytest.fixture(scope="module")
def rwz_grids():
    """The reference's production rwz flux grid (built once, ~10 s) and the
    same grid carried into the port."""
    ref = j_flux.default_flux_grid(True, True, True)
    return ref, convert.flux_grid_from_numpy(*ref, device="cpu")


# ---------------------------------------------------------------- interp2d


@pytest.mark.parametrize("name", ["interp2d_bicubic", "interp2d_bicubic_dense"])
def test_interp2d(name):
    rng = np.random.default_rng(52)
    nx, ny = 11, 8
    x0, dx, y0, dy = -0.7, 0.23, 0.05, 0.11
    values = rng.standard_normal((nx, ny, 2))
    # inside, on nodes, and well outside the grid on every side
    xq = np.concatenate([rng.uniform(x0 - 1.0, x0 + (nx + 3) * dx, 60), x0 + dx * np.arange(nx)])
    yq = np.concatenate([rng.uniform(y0 - 0.5, y0 + (ny + 3) * dy, 60), y0 + dy * np.arange(nx)])
    ref = getattr(j_interp, name)(x0, dx, y0, dy, jnp.asarray(values), jnp.asarray(xq), jnp.asarray(yq))
    got = getattr(t_interp, name)(x0, dx, y0, dy, _t(values), _t(xq), _t(yq))
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert _rel(ref, got) < 1e-13
    # a (B, 1) x (1, K) query broadcasts like the reference's
    ref2 = getattr(j_interp, name)(x0, dx, y0, dy, jnp.asarray(values),
                                   jnp.asarray(xq[:5, None]), jnp.asarray(yq[None, :7]))
    got2 = getattr(t_interp, name)(x0, dx, y0, dy, _t(values), _t(xq[:5, None]), _t(yq[None, :7]))
    assert got2.shape == (5, 7, 2) and _rel(ref2, got2) < 1e-13


# -------------------------------------------------------------------- tail


def test_complex_lgamma():
    rng = np.random.default_rng(53)
    z_re = rng.uniform(1.0, 9.0, 200)
    z_im = rng.uniform(-6.0, 6.0, 200)
    ref = j_tail.complex_lgamma(jnp.asarray(z_re), jnp.asarray(z_im))
    got = t_tail.complex_lgamma(_t(z_re), _t(z_im))
    for a, b in zip(ref, got):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-12 * np.max(np.abs(np.asarray(a)))


def test_tail_factor_and_modulus():
    rng = np.random.default_rng(54)
    ls = np.array([2, 2, 3, 4, 5, 6, 2, 3])
    # both signs of omega, and tiny |omega|
    omega = np.concatenate([rng.uniform(-0.4, 0.4, (40, 8)), rng.uniform(-1e-9, 1e-9, (4, 8))])
    for r0 in (2.0, 3.5):
        ref = j_tail.tail_factor(ls, jnp.asarray(omega), r0=r0)
        got = t_tail.tail_factor(ls, _t(omega), r0=r0)
        mod = np.hypot(*(np.asarray(x) for x in ref))
        for a, b in zip(ref, got):
            assert np.max(np.abs(np.asarray(a) - b.numpy()) / mod) < 1e-12
    ref_sq = j_tail.tail_modulus_sq(ls, jnp.asarray(omega))
    got_sq = t_tail.tail_modulus_sq(ls, _t(omega))
    assert np.max(np.abs(np.asarray(ref_sq) - got_sq.numpy()) / np.asarray(ref_sq)) < 1e-12
    # the Lanczos path against the closed form, inside the port
    t_re, t_im = t_tail.tail_factor(ls, _t(omega))
    assert float(torch.max(torch.abs(t_re * t_re + t_im * t_im - got_sq) / got_sq)) < 1e-11


# --------------------------------------------------------------------- rho


def test_rho_tables_equal_reference():
    assert t_rho._RHO == j_rho._RHO and t_rho._DELTA == j_rho._DELTA
    assert (t_rho._GAMMA_E, t_rho._LN2, t_rho._X_MAX) == (j_rho._GAMMA_E, j_rho._LN2, j_rho._X_MAX)
    assert t_back._U_SHIFT == j_back._U_SHIFT


def test_factorized_correction(orbits):
    p, e = orbits
    rng = np.random.default_rng(55)
    ls = np.array([2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 7, 8])
    ms = np.array([2, 1, 0, 3, 1, 2, 4, 2, 3, 1, 5, 2, 6, 0, 7, 8])
    omega = rng.uniform(-0.3, 0.3, p.shape + ls.shape)
    omega[0, 0, :4] = [0.0, 1e-12, 0.9, -0.9]  # x -> 0 and the x clamp
    for a, b in zip(j_rho.source_factors(jnp.asarray(p), jnp.asarray(e)),
                    t_rho.source_factors(_t(p), _t(e))):
        assert _rel(a, b) < 1e-14
    x_ref = j_rho._x_of_mode(jnp.asarray(omega), ms)
    x_got = t_rho._x_of_mode(_t(omega), ms)
    assert np.max(np.abs(np.asarray(x_ref) - x_got.numpy())) < 1e-15
    assert _rel(j_rho.rho_l_pow(ls, ms, x_ref), t_rho.rho_l_pow(ls, ms, x_got)) < 1e-12
    assert _rel(j_rho.delta_lm(ls, ms, x_ref), t_rho.delta_lm(ls, ms, x_got)) < 1e-12
    for include_delta in (True, False):
        ref = j_rho.factorized_correction(ls, ms, jnp.asarray(p), jnp.asarray(e),
                                          jnp.asarray(omega), include_delta=include_delta)
        got = t_rho.factorized_correction(ls, ms, _t(p), _t(e), _t(omega),
                                          include_delta=include_delta)
        mod = np.hypot(*(np.asarray(x) for x in ref))
        for a, b in zip(ref, got):
            assert np.max(np.abs(np.asarray(a) - b.numpy()) / mod) < 1e-12


# ------------------------------------------------------- rwz calibration


def test_rwz_tables_equal_reference():
    for name in ("X_LO", "X_HI", "N_X"):
        assert getattr(t_bdata, name) == getattr(j_bdata, name), name
    assert sorted(t_bdata.B_TABLE) == sorted(j_bdata.B_TABLE)
    for key, row in j_bdata.B_TABLE.items():
        np.testing.assert_array_equal(t_bdata.B_TABLE[key], row)
    for name in ("U0", "DU", "E0", "DE", "N_U", "N_E"):
        assert getattr(t_rdata, name) == getattr(j_rdata, name), name
    for tab in ("R_TABLE", "R_ERR_REL"):
        ref, got = getattr(j_rdata, tab), getattr(t_rdata, tab)
        assert sorted(got) == sorted(ref)
        for key, arr in ref.items():
            np.testing.assert_array_equal(got[key], arr)
    ls, ms = np.array([2, 2, 3, 9]), np.array([2, 0, -3, 1])
    np.testing.assert_array_equal(t_rwz._mode_rows(ls, ms), j_rwz._mode_rows(ls, ms))


def test_rwz_correction(small_table):
    _, tt = small_table
    rng = np.random.default_rng(56)
    lo, hi = j_bdata.X_LO, j_bdata.X_HI
    # inside, on the nodes, at both ends and beyond them, and x -> 0
    x = np.exp(rng.uniform(np.log(lo) - 1.0, np.log(hi) + 0.5, (50, tt.num_modes)))
    x[0] = np.exp(np.linspace(np.log(lo), np.log(hi), tt.num_modes))
    x[1, :4] = [0.0, lo, hi, 0.3]
    ref = np.asarray(j_rwz.rwz_correction(tt.ls, tt.ms, jnp.asarray(x)))
    got = t_rwz.rwz_correction(tt.ls, tt.ms, _t(x))
    assert got.dtype == torch.float64
    assert np.max(np.abs(ref - got.numpy()) / np.abs(ref)) < 2e-6
    rows = t_rwz.rwz_rows(tt.ls, tt.ms, tt.ns, "cpu")[0]
    assert torch.equal(t_rwz.rwz_correction(tt.ls, tt.ms, _t(x), rows=rows), got)
    # uncalibrated (m = 0) modes are 1 (to the float32 sum of the weights)
    assert np.max(np.abs(got.numpy()[:, tt.ms == 0] - 1.0)) < 1e-6


def test_rwz_ecc_residual(small_table):
    _, tt = small_table
    rng = np.random.default_rng(57)
    u_hi = j_rdata.U0 + (j_rdata.N_U - 1) * j_rdata.DU
    e_hi = j_rdata.E0 + (j_rdata.N_E - 1) * j_rdata.DE
    # inside and outside the table on every side, and on its nodes
    u = rng.uniform(j_rdata.U0 - 0.5, u_hi + 0.5, (4, 40))
    e = rng.uniform(-0.02, e_hi + 0.1, (4, 40))
    u[0, :16] = j_rdata.U0 + j_rdata.DU * np.arange(16)
    e[0, :13] = j_rdata.E0 + j_rdata.DE * np.arange(13)
    ref = j_rwz.rwz_ecc_residual(tt.ls, tt.ms, tt.ns, jnp.asarray(u), jnp.asarray(e))
    got = t_rwz.rwz_ecc_residual(tt.ls, tt.ms, tt.ns, _t(u), _t(e))
    mod = np.hypot(*(np.asarray(x) for x in ref))
    assert got[0].shape == (4, 40, tt.num_modes) and got[0].dtype == torch.float64
    for a, b in zip(ref, got):
        assert np.max(np.abs(np.asarray(a) - b.numpy()) / mod) < 2e-6
    got_mod = torch.hypot(*got).numpy()
    assert got_mod.min() >= 0.15 * (1 - 1e-6) and got_mod.max() <= 6.0 * (1 + 1e-6)
    # modes without a row are 1 + 0i (to the float32 sum of the weights)
    no_row = np.array([(int(l), int(m), int(n)) not in j_rdata.R_TABLE for l, m, n in zip(*tt)])
    assert no_row.any() and np.max(np.abs(got[0].numpy()[..., no_row] - 1.0)) < 2e-6
    assert np.all(got[1].numpy()[..., no_row] == 0.0)
    rows = t_rwz.rwz_rows(tt.ls, tt.ms, tt.ns, "cpu")[1]
    again = t_rwz.rwz_ecc_residual(tt.ls, tt.ms, tt.ns, _t(u), _t(e), rows=rows)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_rwz_clamp_engages():
    # a table whose interpolant leaves [0.15, 6.0] is clamped in modulus and
    # keeps its phase, as in the reference
    rng = np.random.default_rng(58)
    rows = torch.from_numpy(
        rng.uniform(-9.0, 9.0, (j_rdata.N_U + 2, j_rdata.N_E + 2, 3, 2)).astype(np.float32))
    u = _t(rng.uniform(j_rdata.U0, j_rdata.U0 + 3.0, 300))
    e = _t(rng.uniform(0.05, 0.7, 300))
    re, im = t_rwz.rwz_ecc_residual([2] * 3, [2] * 3, [0] * 3, u, e, rows=rows)
    mod = torch.hypot(re, im)
    assert float(mod.max()) <= 6.0 * (1 + 1e-6) and float(mod.min()) >= 0.15 * (1 - 1e-6)
    assert float(mod.max()) > 5.99 and float(mod.min()) < 0.2


# -------------------------------------------------------------- amplitudes


def _multiplier(table, p, e, omega, tail=False, tail_r0=2.0, factorized=False, rwz=False):
    """|T S rho^l B R| of a rung per (orbit, mode), from the reference."""
    om, pj, ej = jnp.asarray(omega), jnp.asarray(p), jnp.asarray(e)
    mult = np.ones(omega.shape)
    if tail:
        mult = mult * np.hypot(*(np.asarray(x) for x in j_tail.tail_factor(table.ls, om, r0=tail_r0)))
    if factorized:
        mult = mult * np.hypot(*(np.asarray(x) for x in j_rho.factorized_correction(
            table.ls, table.ms, pj, ej, om)))
    if rwz:
        b = np.asarray(j_rwz.rwz_correction(table.ls, table.ms, j_rho._x_of_mode(om, table.ms)))
        r = np.hypot(*(np.asarray(x) for x in j_rwz.rwz_ecc_residual(
            table.ls, table.ms, table.ns, j_back.u_of_pe(pj, ej), ej)))
        mult = mult * b * r
    return mult


def _assert_rung_parity(p, e, jt, tt, kw):
    """A rung multiplies the flat amplitude A0 by a factor c: the two
    packages' results differ by |c| |A0 - A0'| (the flat float32 projections'
    own disagreement, held to 1e-5 of the family floor by
    test_torch_amplitude.py) plus what the rung itself adds, |c - c'| |A0|.
    The second part must stay within 2e-6 of the family's projection floor
    |C_lm| |omega_mn|^l max_n |F_n|, the whole within 2e-5 of it."""
    pj, ej = jnp.asarray(p), jnp.asarray(e)
    flat_ref = j_amp.mode_amplitudes(pj, ej, jt)
    flat_got = t_amp.mode_amplitudes(_t(p), _t(e), tt)
    ref = j_amp.mode_amplitudes(pj, ej, jt, **kw)
    got = t_amp.mode_amplitudes(_t(p), _t(e), tt, **kw)
    assert got[0].dtype == torch.float64 and got[0].shape == ref[0].shape
    n_max = int(np.max(np.abs(jt.ns)))
    f_fam, om_phi, om_r = j_amp._orbit_harmonics(pj, ej, n_max)
    f_max = np.abs(np.asarray(f_fam)).max(axis=-1)
    fam_idx = np.array([j_amp._FAMILY_ORDER.index((l, m)) for l, m in zip(jt.ls, jt.ms)])
    c_abs = np.array([np.hypot(*j_amp._FAMILIES[(l, m)][3:]) for l, m in zip(jt.ls, jt.ms)])
    omega = (jt.ms * np.asarray(om_phi)[..., None] + jt.ns * np.asarray(om_r)[..., None]).astype(np.float64)
    mult = _multiplier(jt, p, e, omega, **kw)
    floor = c_abs * np.abs(omega) ** jt.ls * f_max[..., fam_idx] * mult

    def dist(x, y):
        return np.hypot(np.asarray(x[0]) - y[0].numpy(), np.asarray(x[1]) - y[1].numpy())

    err = dist(ref, got)
    assert np.max((err - mult * dist(flat_ref, flat_got)) / floor) < 2e-6
    assert np.max(err / floor) < 2e-5


@pytest.mark.parametrize("rung", list(RUNGS))
def test_mode_amplitudes_rungs(orbits, small_table, rung):
    _assert_rung_parity(*orbits, *small_table, RUNGS[rung])


def test_full_fidelity_amplitudes(orbits):
    p, e = orbits
    jt = j_amp.default_mode_table(30)
    tt = t_amp.ModeTable(*jt)
    _assert_rung_parity(p, e, jt, tt, RUNGS["rwz"])
    ref = j_amp.full_fidelity_amplitudes(jnp.asarray(p), jnp.asarray(e), jt)
    got = t_amp.full_fidelity_amplitudes(_t(p), _t(e), tt)
    again = t_amp.mode_amplitudes(_t(p), _t(e), tt, **RUNGS["rwz"])
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    for a, b in zip(ref, j_amp.mode_amplitudes(jnp.asarray(p), jnp.asarray(e), jt, **RUNGS["rwz"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the batch-frozen module's precomputed rows change nothing
    again = t_amp.mode_amplitudes(
        _t(p), _t(e), tt, rwz_rows=t_rwz.rwz_rows(tt.ls, tt.ms, tt.ns, "cpu"), **RUNGS["rwz"]
    )
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    with pytest.raises(ValueError):
        t_amp.mode_amplitudes(_t(p), _t(e), tt, tail=True, rwz=True)


# -------------------------------------------------------------------- flux

# The flux sums |A|^2 of float32 projections, whose noise grows with
# eccentricity. A scan over e in [0, 0.78] and p - p_sep in [0.02, 9.5] read:
# the reference's own jitted and eager evaluations differ by up to 2.4e-5 for
# e <= 0.52 and 1.6e-4 above, and the two packages by up to 1.7e-5 and 1.6e-4.
# Held to 5e-5 up to e = 0.53 and to 5e-4 beyond (the grid's e = 0.65 and 0.78
# columns); no tighter bound holds for the reference against itself.
_E_QUIET, _TOL_QUIET, _TOL_LOUD = 0.53, 5e-5, 5e-4

FLAGS = {
    "flat": dict(),
    "tail": dict(tail=True),
    "rwz": dict(tail=True, factorized=True, rwz=True),
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_flux_from_modes(orbits, flags):
    p, e = orbits
    ref = j_flux.flux_from_modes(jnp.asarray(p), jnp.asarray(e), **FLAGS[flags])
    got = t_flux.flux_from_modes(_t(p), _t(e), **FLAGS[flags])
    for a, b in zip(ref, got):
        assert b.shape == p.shape and bool((b < 0).all())
        rel = np.abs(np.asarray(a) - b.numpy()) / np.abs(np.asarray(a))
        assert np.max(rel[e <= _E_QUIET]) < _TOL_QUIET and np.max(rel) < _TOL_LOUD
    with pytest.raises(ValueError):
        t_flux.flux_from_modes(_t(p), _t(e), rwz=True)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_build_flux_grid_small(flags, monkeypatch):
    kw = dict(n_u=12, n_e=7, **FLAGS[flags])
    ref = j_flux.build_flux_grid(**kw)
    # chunked evaluation: 84 points in chunks of 32
    monkeypatch.setattr(t_flux, "_GRID_CHUNK", 32)
    got = t_flux.build_flux_grid(**kw, device="cpu")
    assert (got.u0, got.du, got.e0, got.de) == (ref.u0, ref.du, ref.e0, ref.de)
    assert got.values.shape == (12, 7, 2) and got.values.dtype == torch.float64
    rel = np.abs(ref.values - got.values.numpy()) / np.abs(ref.values)
    quiet = np.linspace(1e-6, 0.78, 7) <= _E_QUIET
    assert np.max(rel[:, quiet]) < _TOL_QUIET and np.max(rel) < _TOL_LOUD


def test_default_flux_grid_is_cached_per_device(monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return t_flux.FluxGrid(0.0, 1.0, 0.0, 1.0, torch.zeros((4, 4, 2), dtype=torch.float64))

    monkeypatch.setattr(t_flux, "build_flux_grid", fake)
    monkeypatch.setattr(t_flux, "_DEFAULT_GRIDS", {})
    a = t_flux.default_flux_grid(True, True, True, device="cpu")
    assert t_flux.default_flux_grid(True, True, True, device="cpu") is a
    assert t_flux.default_flux_grid(True, False, False, device="cpu") is not a
    assert len(calls) == 2 and calls[0]["device"] == torch.device("cpu")
    assert all("cpu" in key[3] for key in t_flux._DEFAULT_GRIDS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_flux.default_flux_grid(True, True, True)


@pytest.mark.parametrize("dense", [False, True])
def test_multipole_flux_on_carried_grid(orbits, rwz_grids, dense):
    p, e = orbits
    j_grid, t_grid = rwz_grids
    assert t_grid.values.shape == (96, 49, 2)
    np.testing.assert_array_equal(t_grid.values.numpy(), j_grid.values)
    # orbit points inside the grid, below its first u node and past e = 0.78
    p = np.concatenate([p.ravel(), [6.2012, 6.9, 30.0, 9.0]])
    e = np.concatenate([e.ravel(), [0.1, 0.44, 0.2, 0.85]])
    ref = j_flux.multipole_flux_e_l(jnp.asarray(p), jnp.asarray(e), j_grid, dense=dense)
    got = t_flux.multipole_flux_e_l(_t(p), _t(e), t_grid, dense=dense)
    for a, b in zip(ref, got):
        assert np.max(np.abs(np.asarray(a) - b.numpy()) / np.abs(np.asarray(a))) < 1e-12


def test_inspiral_rhs_takes_grid_or_function(orbits, rwz_grids):
    p, e = orbits
    j_grid, t_grid = rwz_grids
    state = np.stack([p.ravel(), e.ravel(), np.ones(p.size), np.full(p.size, 2.0)], axis=-1)
    nu = 1e-5
    ref = jax.vmap(lambda s: j_flux.inspiral_rhs(
        s, j_flux.InspiralRHS(nu=jnp.asarray(nu)),
        flux_fn=lambda p_, e_: j_flux.multipole_flux_e_l(p_, e_, j_grid)))(jnp.asarray(state))
    nu_t = torch.tensor(nu, dtype=torch.float64)
    got = t_flux.inspiral_rhs(_t(state), nu_t, t_grid)
    assert _rel(ref, got) < 1e-12
    same = t_flux.inspiral_rhs(
        _t(state), nu_t, lambda p_, e_: t_flux.multipole_flux_e_l(p_, e_, t_grid))
    assert torch.equal(same, got)
    # forward-mode differentiable through the table walk (the integrator's
    # tail padding takes this jvp)
    _, tangent = torch.func.jvp(lambda s: t_flux.inspiral_rhs(s, nu_t, t_grid), (_t(state),), (got,))
    ref_t = jax.vmap(lambda s, v: jax.jvp(
        lambda y: j_flux.inspiral_rhs(
            y, j_flux.InspiralRHS(nu=jnp.asarray(nu)),
            flux_fn=lambda p_, e_: j_flux.multipole_flux_e_l(p_, e_, j_grid)), (s,), (v,))[1])(
        jnp.asarray(state), ref)
    assert np.max(np.abs(np.asarray(ref_t) - tangent.numpy())) / np.max(np.abs(np.asarray(ref_t))) < 1e-10


# -------------------------------------------------------------- trajectory


def _fixed_time_rel(t_a, y_a, t_b, y_b, t_fixed):
    a = spline_eval(fit_cubic_spline(t_a, y_a, "not-a-knot"), t_fixed)
    b = spline_eval(fit_cubic_spline(t_b, y_b, "not-a-knot"), t_fixed)
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(a)))


def test_rwz_trajectory_on_carried_grid(rwz_grids):
    # Two chirping lanes and one that plunges inside the horizon. Where the
    # two packages take the same step sequence the knots agree to 1e-12.
    # Where the sequences part by a step or two (as they may under the
    # Peters-Mathews flux too) the solutions agree to the integrator's real
    # global error over the C^1 bicubic table, which its 1e-11 step control
    # does not see at grid lines: measured 1e-10 to 5e-9 in the phases and
    # 3e-9 to 3e-8 in (p, e) at fixed times; held to 1e-7.
    p0, e0 = (10.0, 7.5, 12.0), (0.4, 0.3, 0.35)
    kw = dict(t_years=0.3, max_steps=192, flux="multipole_rwz")
    got = t_insp.schwarz_ecc_flux_inspiral(
        1e6, 50.0, torch.tensor(p0, dtype=torch.float64), torch.tensor(e0, dtype=torch.float64),
        Phi_phi0=1.0, Phi_r0=2.0, flux_grid=rwz_grids[1], **kw,
    )
    same_steps = 0
    for i in range(len(p0)):
        ref = j_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, p0[i], e0[i], Phi_phi0=1.0, Phi_r0=2.0, **kw)
        n, n_got = int(ref.n), int(got.n[i])
        assert abs(n_got - n) <= 2 and n < 192
        t_ref, t_got = np.array(ref.t), got.t[i].numpy()
        t_end = min(t_ref[n - 1], t_got[n_got - 1])
        assert abs(t_ref[n - 1] - t_got[n_got - 1]) < 1e-6 * t_end
        if n == n_got and np.max(np.abs(t_ref[:n] - t_got[:n])) < 1e-12 * t_end:
            same_steps += 1
            for field in ("Phi_phi", "Phi_r", "p", "e"):
                assert _rel(np.array(getattr(ref, field))[:n], getattr(got, field)[i, :n]) < 1e-12
            continue
        t_fixed = torch.linspace(0.0, t_end, 193, dtype=torch.float64)
        for field in ("Phi_phi", "Phi_r", "p", "e"):
            rel = _fixed_time_rel(
                _t(t_ref), _t(np.array(getattr(ref, field))), got.t[i], getattr(got, field)[i], t_fixed,
            )
            assert rel < 1e-7, (field, rel)
    assert same_steps >= 1
    with pytest.raises(ValueError):
        t_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, 10.0, 0.4, flux="teukolsky", device="cpu")


def test_duration_roots_on_carried_grid(rwz_grids):
    kw = dict(n_iters=10, max_steps=192)
    ref = float(j_insp.get_p_at_t(1e6, 50.0, 0.3, 0.25, flux="multipole_rwz", **kw))
    got = t_insp.get_p_at_t(1e6, 50.0, torch.tensor([0.3], dtype=torch.float64), 0.25,
                            flux="multipole_rwz", flux_grid=rwz_grids[1], **kw)
    assert abs(float(got[0]) - ref) < 1e-12 * ref
    ref_mu = float(j_insp.get_mu_at_t(1e6, 9.0, 0.3, 0.25, **kw))
    got_mu = t_insp.get_mu_at_t(1e6, torch.tensor([9.0], dtype=torch.float64), 0.3, 0.25, **kw)
    assert abs(float(got_mu[0]) - ref_mu) < 1e-12 * ref_mu


def test_quad_trajectory_on_carried_grid(rwz_grids):
    # method="quad" under the rwz flux: the port's batch over the carried
    # grid against the reference per lane (which reads the same grid from
    # its cache): a horizon-capped 1-yr lane (the main path's source) and a
    # plunging lane; fields 1e-9 relative, phases 1e-6 rad
    lanes = [(1e6, 10.0, 12.0, 0.35), (1e6, 50.0, 7.6, 0.3)]
    m, mu, p0, e0 = (torch.tensor(c, dtype=torch.float64) for c in zip(*lanes))
    got = t_insp.schwarz_ecc_flux_inspiral(m, mu, p0, e0, t_years=1.0, max_steps=192,
                                           flux="multipole_rwz", flux_grid=rwz_grids[1],
                                           method="quad")
    assert bool((got.n == 192).all())
    assert got.t[1, -1] < 0.5 * got.t[0, -1]  # the second lane plunges
    for i, lane in enumerate(lanes):
        ref = j_insp.schwarz_ecc_flux_inspiral(*lane, t_years=1.0, max_steps=192,
                                               flux="multipole_rwz", method="quad")
        for field in ("t", "p", "e", "Phi_phi", "Phi_r"):
            a, b = np.asarray(getattr(ref, field)), getattr(got, field)[i].numpy()
            err = np.max(np.abs(a - b))
            bound = 1e-6 if field.startswith("Phi") else 1e-9 * np.max(np.abs(a))
            assert err <= bound, (i, field, err)


def test_quad_vs_dp5_yardstick_reference():
    """The JAX package's own quad-vs-dp5 distance at the main path's
    configuration, one lane (the batch's source, 1 yr, rwz physics, 16
    slots frozen from dp5's eps selection on the l <= 6 table, 256-run
    windows of 64 bins, 2 turnover slots): the largest |Delta Phi_phi| at
    dp5's knots and the worst channel's relative L2 distance of the FD
    output. It is what the card's quad batch is read against (chip_smoke.py
    prints the port's at full width); held to the reference test's bounds
    (tests/test_trajectory.py: 2e-3 rad, 1e-3)."""
    from scipy.interpolate import CubicSpline

    table = j_amp.default_mode_table(30)
    src = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)
    freq = j_wf.default_frequencies(1.0, 10.0)
    f_np = freq[freq > 0]
    f0, df = float(f_np[0]), float(f_np[1] - f_np[0])
    kw = dict(t_years=1.0, k_max=16, eps=1e-2, max_steps=192, **RWZ)
    idx = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(*src, table=table, **kw).sel.idx)())
    table_k = j_amp.ModeTable(table.ls[idx], table.ms[idx], table.ns[idx])
    pros, outs = {}, {}
    for method in ("dp5", "quad"):
        pros[method] = jax.jit(lambda: j_wf.waveform_prologue(
            *src, table=table_k, forced_idx=np.arange(16), traj_method=method, **kw))()
        if method == "dp5":
            offsets = j_wf.band_offsets_for(pros[method], table_k, f0, df, 64, 256)
        outs[method] = [np.asarray(o, np.float64) for o in jax.jit(lambda p: j_wf.fd_waveform_core(
            p, table_k, jnp.zeros(len(f_np)), channels=True, uniform=(f0, df), band_runs=256,
            band_offsets=offsets, bins_per_run=64, turnover_slots=2, extra_band_runs=64,
            out_f32=True))(pros[method])]
    d, q = pros["dp5"], pros["quad"]
    n = int(d.n_live)
    t_d, t_q = np.asarray(d.t_knots)[:n], np.asarray(q.t_knots)
    on = t_d <= t_q[-1]
    dphi = np.max(np.abs(CubicSpline(t_q, np.asarray(q.phi_phi))(t_d[on])
                         - np.asarray(d.phi_phi)[:n][on]))
    rel = max(np.linalg.norm(a - b) / np.linalg.norm(a) for a, b in zip(outs["dp5"], outs["quad"]))
    print(f"[reference quad vs dp5, 1 yr rwz, one lane] max |dPhi_phi| at dp5's {n} knots "
          f"{dphi:.4e} rad, FD rel L2 {rel:.4e}")
    assert np.isfinite(rel) and dphi < 2e-3 and rel < 1e-3


# ------------------------------------------------- the frozen rwz batch


def test_frozen_rwz_batch_matches_reference(small_table, rwz_grids):
    """The production configuration at small size: a 0.05-yr source on a
    20000-bin uniform grid, the sliced table as the frozen slots, shared
    window offsets, 2 turnover slots, float32 output, rwz physics throughout
    (the trajectory over the carried flux grid). Same tolerance form as
    test_torch_waveform.py::test_frozen_batch_matches_reference: per channel
    relative L2 <= 1e-5 and max/scale <= 1e-4."""
    jt, tt = small_table
    f0, df, nf = 1.7e-3, 2e-8, 20000
    r, runs = 8, 2048
    idx_k = np.arange(jt.num_modes)
    kw = dict(t_years=0.05, table=jt, k_max=jt.num_modes, eps=1e-2, max_steps=160,
              forced_idx=idx_k, **RWZ)
    prologue = jax.jit(lambda p0, e0, th, ph: j_wf.waveform_prologue(
        1e6, 50.0, p0, e0, th, ph, 1.0, 0.0, 0.0, **kw))
    pro0 = prologue(10.0, 0.4, 0.7, 0.5)
    offsets = j_wf.band_offsets_for(pro0, jt, f0, df, r, runs)
    pro0_t = t_wf.waveform_prologue(
        1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 0.0, 0.0, **{**kw, "table": tt},
        flux_grid=rwz_grids[1], device="cpu")
    np.testing.assert_array_equal(t_wf.band_offsets_for(pro0_t, tt, f0, df, r, runs), offsets)

    gen = t_wf.FrozenFDWaveform(
        tt, offsets, f0=f0, df=df, nf=nf, t_years=0.05, mass_1=1e6, mass_2=50.0, max_steps=160,
        bins_per_run=r, band_runs=runs, turnover_slots=2, extra_band_runs=64,
        flux_grid=rwz_grids[1], device="cpu", **RWZ,
    )
    state = gen.state_dict()
    assert state["flux_values"].shape == (96, 49, 2) and state["flux_values"].dtype == torch.float64
    assert state["rwz_b_rows"].shape == (tt.num_modes, j_bdata.N_X + 2)
    assert state["rwz_r_rows"].shape == (j_rdata.N_U + 2, j_rdata.N_E + 2, tt.num_modes, 2)

    core = jax.jit(lambda pro: j_wf.fd_waveform_core(
        pro, jt, jnp.zeros(nf), channels=True, uniform=(f0, df), band_runs=runs,
        band_offsets=jnp.asarray(offsets), bins_per_run=r, turnover_slots=2, extra_band_runs=64,
        band_offsets_extra=jnp.zeros(2, jnp.int32), out_f32=True))
    lanes = [(10.02, 0.402, 0.72, 0.52), (9.97, 0.397, 0.69, 0.47)]
    got = gen(*(torch.tensor(v, dtype=torch.float64) for v in zip(*lanes)))
    assert all(o.shape == (2, nf) and o.dtype == torch.float32 for o in got)
    for lane, src in enumerate(lanes):
        ref = core(prologue(*src))
        for a, b in zip(ref, got):
            a = np.asarray(a, np.float64)
            b = b[lane].double().numpy()
            assert np.all(np.isfinite(b)) and np.count_nonzero(a) > 1000
            assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-5
            assert np.max(np.abs(a - b)) / np.max(np.abs(a)) <= 1e-4
    # a flat-physics module registers no grid and no calibration rows
    flat = t_wf.FrozenFDWaveform(tt, offsets, f0=f0, df=df, nf=nf, t_years=0.05, device="cpu")
    assert flat.flux_values is None and flat.rwz_b_rows is None
    assert "flux_values" not in flat.state_dict()
