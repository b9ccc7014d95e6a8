"""The RWZ calibration twins against their JAX originals, on the CPU:
`tools/rwz/torch_calibrate.py`, `torch_calibrate_ecc.py` and
`torch_holdout_check.py` (from `calibrate.py`, `calibrate_ecc.py` and
`holdout_check.py`).

The RWZ solver (`tools/rwz/circular.py`, `eccentric.py`) is shared, so the
exact side of each ratio is the original's to the bit; each test solves one
mode at one node or midpoint. The model sides differ by where they round:

* B_lm's F_model goes through `mode_amplitudes`' float32 projection in
  both packages: 5e-5 relative (the flux-grid tolerance of
  `tests/test_torch_rwz.py`), so B within 2.5e-5;
* `model_amplitudes_f64` is float64 throughout, but a weak harmonic is a
  sum of terms as large as the strong ones: 1e-13 of the orbit's largest
  amplitude, and 1e-9 relative for every mode above 1e-5 of the largest;
* R and the held-out deviations carry the B and R tables' float32
  interpolation, which both packages do in float32: 1e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models.rho import _x_of_mode
from emri_frequencydomainwaveforms_tpu.models.rwz_calibration import (
    rwz_correction,
    rwz_ecc_residual,
)
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude as t_amp
from tools.rwz import calibrate_ecc as j_ecc
from tools.rwz import torch_calibrate as t_cal
from tools.rwz import torch_calibrate_ecc as t_ecc
from tools.rwz.eccentric import darwin_orbit, eccentric_amplitude


def _jax_mods():
    from emri_frequencydomainwaveforms_tpu.models.geodesic import fundamental_frequencies
    from emri_frequencydomainwaveforms_tpu.models.rho import factorized_correction
    from emri_frequencydomainwaveforms_tpu.models.tail import tail_modulus_sq

    return (jnp, j_amp.mode_amplitudes, fundamental_frequencies, tail_modulus_sq,
            factorized_correction)


def test_model_flux_matches_the_original():
    from tools.rwz import calibrate as j_cal

    table_j, table_t = j_amp.default_mode_table(2, l_max=8), t_amp.default_mode_table(2, l_max=8)
    pairs = t_cal.calibration_pairs(table_t)
    assert len(pairs) == 35 and pairs[0] == (2, 1) and pairs[-1] == (8, 8)
    xs = t_cal.x_grid()
    got = t_cal.model_flux_modes(pairs, xs, table_t, "cpu")
    assert got.shape == (35, 28) and np.isfinite(got).all() and (got > 0).all()
    mods = _jax_mods()
    for row in (0, 1, 5, 17, 34):
        l, m = pairs[row]
        for i in (0, 14, 27):
            ref = j_cal.model_flux_mode(l, m, 1.0 / xs[i], table_j, mods)
            assert abs(got[row, i] / ref - 1.0) < 5e-5, (l, m, i)


def test_b_value_matches_the_original_and_the_committed_table():
    """One (l, m) at one x: the exact flux is the original's expression on
    the same solver, and B against the committed port table within the
    model side's 2.5e-5."""
    from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_calibration_data as data
    from tools.rwz.circular import even_circular_amplitude

    from math import factorial, pi

    xs = t_cal.x_grid()
    l, m, i = 2, 2, 20
    c, om = even_circular_amplitude(l, m, 1.0 / xs[i])
    ref = factorial(l + 2) / factorial(l - 2) / (8 * pi) * abs(om * c / 2.0) ** 2
    assert t_cal.exact_flux_mode(l, m, xs[i]) == ref
    f_model = t_cal.model_flux_modes([(l, m)], xs[i:i + 1], t_amp.default_mode_table(2, l_max=8),
                                     "cpu")[0]
    b = t_cal.b_row(l, m, xs[i:i + 1], f_model)
    assert abs(b[0] / data.B_TABLE[(l, m)][i] - 1.0) < 2.5e-5


@pytest.mark.parametrize("p,e,n_chi", [(9.0, 0.3, 1024), (7.2, 0.55, 512), (20.0, 0.05, 512)])
def test_model_amplitudes_f64_match_the_original(p, e, n_chi):
    table_j, table_t = j_amp.default_mode_table(12, l_max=6), t_amp.default_mode_table(12, l_max=6)
    tls, tms, tns = table_t.ls, table_t.ms, table_t.ns
    orb = darwin_orbit(p, e, n_chi)
    ref = j_ecc.model_amplitudes_f64(p, e, orb, table_j, tls, tms, tns)
    got = t_ecc.model_amplitudes_f64(p, e, orb, table_t, tls, tms, tns, device="cpu")
    top = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-13 * top
    above = np.abs(ref) > 1e-5 * top
    assert above.sum() > 50
    assert np.max(np.abs(got[above] / ref[above] - 1.0)) <= 1e-9


def test_calibrate_node_matches_the_original():
    """R and its error for one mode at one grid node of the original's
    default grid (node (2, 3), n_chi 1024), as the original's loop body
    computes them."""
    from math import factorial as _fac

    from emri_frequencydomainwaveforms_tpu.models.amplitude_backends import _U_SHIFT

    us, es = t_ecc.grid_axes(10, 6, 0.55)
    assert np.array_equal(us, np.linspace(np.log(_U_SHIFT + 0.05), np.log(16.0), 10))
    p, e = t_ecc.p_of_node(us[2], es[3]), float(es[3])
    table_j, table_t = j_amp.default_mode_table(12, l_max=4), t_amp.default_mode_table(12, l_max=4)
    key = (3, 3, 1)
    mode_idx = t_ecc.mode_index(table_t, [(3, 3)], [1])
    k = mode_idx[key]
    got = t_ecc.calibrate_node(p, e, 1024, table_t, mode_idx, device="cpu")

    tls, tms, tns = (np.asarray(a) for a in (table_j.ls, table_j.ms, table_j.ns))
    orb = darwin_orbit(p, e, 1024)
    a_base = j_ecc.model_amplitudes_f64(p, e, orb, table_j, tls, tms, tns)
    om_all = tms * orb["Om_phi"] + tns * orb["Om_r"]
    a_base = a_base * np.asarray(rwz_correction(tls, tms, _x_of_mode(jnp.asarray(om_all), tms)))
    c_rwz, _, c_coarse = eccentric_amplitude(3, 3, 1, p, e, _orbit=orb, return_coarse=True)
    norm = np.sqrt(8.0 * np.pi * _fac(5) / _fac(1) / (8.0 * np.pi))
    r_ref = norm * c_rwz / 2.0 / complex(a_base[k])  # even parity: l + m even
    err_ref = float(abs(c_rwz - c_coarse) / max(abs(c_rwz), 1e-300))
    r, err = got[key]
    assert abs(r / r_ref - 1.0) < 1e-5
    assert err == err_ref


def test_holdout_midpoint_matches_the_original():
    """The held-out deviations of one mode at the first midpoint, as the
    original's loop body computes them."""
    from math import factorial as _fac

    from emri_frequencydomainwaveforms_tpu.models import _rwz_ecc_data as j_data
    from emri_frequencydomainwaveforms_tpu.models.amplitude_backends import _U_SHIFT
    from tools.rwz import torch_holdout_check as t_ho

    us, es = t_ho.midpoints(6)
    assert np.array_equal(us, j_data.U0 + np.linspace(0.5, j_data.N_U - 1.5, 6) * j_data.DU)
    u, e = us[1], float(es[1])
    table_j, table_t = j_amp.default_mode_table(12, l_max=4), t_amp.default_mode_table(12, l_max=4)
    mode_idx = t_ecc.mode_index(table_t, [(2, 2)], [0])
    d_got, a_got = t_ho.midpoint_devs(u, e, table_t, mode_idx, device="cpu")[(2, 2, 0)]

    tls, tms, tns = (np.asarray(a) for a in (table_j.ls, table_j.ms, table_j.ns))
    p = float(np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e)
    orb = darwin_orbit(p, e, 1024)
    a_base = j_ecc.model_amplitudes_f64(p, e, orb, table_j, tls, tms, tns)
    om_all = tms * orb["Om_phi"] + tns * orb["Om_r"]
    b_circ = np.asarray(rwz_correction(tls, tms, _x_of_mode(jnp.asarray(om_all), tms)))
    r_re, r_im = rwz_ecc_residual(tls, tms, tns, jnp.asarray(u), jnp.asarray(e))
    r_interp = np.asarray(r_re) + 1j * np.asarray(r_im)
    a_dominant = float(np.max(np.abs(a_base * b_circ * r_interp)))
    k = mode_idx[(2, 2, 0)]
    c_rwz, _ = eccentric_amplitude(2, 2, 0, p, e, _orbit=orb)
    a_rwz = np.sqrt(8.0 * np.pi * _fac(4) / _fac(0) / (8.0 * np.pi)) * c_rwz / 2.0
    r_true = a_rwz / (a_base[k] * b_circ[k])
    d_ref = abs(r_interp[k] / r_true - 1.0)
    a_ref = abs(a_base[k] * b_circ[k] * r_interp[k] - a_rwz) / max(abs(a_rwz),
                                                                     1e-3 * a_dominant)
    assert abs(d_got - d_ref) < 1e-5 and abs(a_got - a_ref) < 1e-5
    assert d_ref < 1e-2
