"""The flux-anchor and multipole-derivation twins against their JAX
originals, on the CPU: `tools/rwz/torch_ecc_flux_check.py`,
`tools/rwz/torch_pn_ecc_flux.py` and `tools/torch_derive_multipoles.py`.

* The corrected stack's model fluxes at held-out midpoints: the original's
  within 1e-6 relative (float64 projection; the B and R tables'
  float32 interpolation in both packages), and against the solver fluxes
  recorded in ``tests/test_ecc_flux_anchor.py`` at that test's tolerances.
* The model stack's small-e flux coefficient: the fixed-frequency
  Peters-Mathews g0 = 157/24 within 1e-4, as the reference's anchor test
  holds the JAX package; the total model flux at an orbit within 1e-12 of
  the original's.
* The multipole constants K_lm recovered on the port's orbit and Ylm equal
  the port's hard-coded ``_FAMILIES`` constants within 1e-10 relative
  (l <= 4 here; the card run derives through l = 8), and the twin's orbit
  data and model harmonics equal the original's within 1e-12.
"""

import numpy as np
import pytest

G0_EXACT = 157.0 / 24.0

# (p, e, F_solver, tolerance) of tests/test_ecc_flux_anchor.py's recorded run
POINTS = [
    (7.500673, 0.244444, 3.4260240176162084e-04, 1.5e-2),
    (10.036079, 0.411111, 8.294336830124971e-05, 5e-3),
    (15.779034, 0.577778, 7.733273957225663e-06, 1e-3),
]


@pytest.mark.parametrize("p,e,f_solver,tol", POINTS)
def test_model_fluxes_match_the_original_and_the_solver(p, e, f_solver, tol):
    from tools.rwz import ecc_flux_check as j_efc
    from tools.rwz import torch_ecc_flux_check as t_efc

    ref = j_efc._model_fluxes(p, e)
    got = t_efc._model_fluxes(p, e, device="cpu")
    for a, b in zip(ref, got):
        assert abs(b / a - 1.0) < 1e-6
    assert abs(got[1] / f_solver - 1.0) < tol


def test_held_out_points_are_the_original():
    """The midpoints of the original's default run (its ``main`` computes
    them inline)."""
    from emri_frequencydomainwaveforms_tpu.models import _rwz_ecc_data as ecc
    from emri_frequencydomainwaveforms_tpu.models.amplitude_backends import _U_SHIFT
    from tools.rwz import torch_ecc_flux_check as t_efc

    iu = np.linspace(4.5, ecc.N_U - 3.5, 3)
    ie = np.linspace(3.5, ecc.N_E - 3.5, 3)
    ref = []
    for ju, je in zip(iu, ie):
        u = ecc.U0 + ju * ecc.DU
        e = float(ecc.E0 + je * ecc.DE)
        ref.append((float(np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e), e))
    assert t_efc.held_out_points(3) == ref


def test_model_total_flux_matches_the_original():
    from tools.rwz import pn_ecc_flux as j_pn
    from tools.rwz import torch_pn_ecc_flux as t_pn

    for p, e in ((60.0, 0.04), (14.0, 0.3)):
        ref = j_pn.model_total_flux(p, e)
        assert abs(t_pn.model_total_flux(p, e, device="cpu") / ref - 1.0) < 1e-12


def test_model_newtonian_e2_coefficient_is_157_over_24():
    """Fixed-frequency e^2 flux slope of the port's model stack -> 157/24
    as v -> 0 (2-point Richardson in v^2 removes the O(v^2) content)."""
    from tools.rwz import torch_pn_ecc_flux as t_pn

    es = (0.002, 0.02, 0.04)
    g1 = t_pn.g_of_v_model(1.0e4, es=es, device="cpu")
    g2 = t_pn.g_of_v_model(4.0e4, es=es, device="cpu")
    v1sq, v2sq = 1.0 / 1.0e4, 1.0 / 4.0e4
    g0 = (g1 * v2sq - g2 * v1sq) / (v2sq - v1sq)
    assert abs(g0 - G0_EXACT) < 1e-4, (g0, G0_EXACT)


def test_multipole_constants_are_the_amplitude_constants():
    from tools import torch_derive_multipoles as t_dm

    fits = t_dm.derive(l_top=4, device="cpu")
    assert [t for t, _, _ in fits] == ["T1_quad", "T2_oct", "T3_curq", "T4_hex", "T5_curoct",
                                       "T6_curhex"]
    assert all(resid < 1e-10 for _, resid, _ in fits)
    dev = t_dm.against_amplitude_constants(fits)
    assert len(dev) == 12 and max(dev.values()) < 1e-10, dev


def test_orbit_and_model_harmonics_match_the_original():
    from tools import derive_multipoles as j_dm
    from tools import torch_derive_multipoles as t_dm

    ref, got = j_dm.orbit_data(10.0, 0.37), t_dm.orbit_data(10.0, 0.37, device="cpu")
    for key in ("r", "dphi", "w", "th", "ell", "om_r", "om_phi"):
        a, b = np.asarray(ref[key]), np.asarray(got[key])
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), key
    t_grid = np.linspace(0.0, 3.1 * 2 * np.pi / ref["om_r"], 31)
    fr = lambda r, l: r**3  # noqa: E731
    fn = j_dm.fourier_family(ref, fr, 3)
    a = j_dm.model_family(ref, fn, 3, 3, 0.8, 0.3, t_grid)
    b = t_dm.model_family(got, fn, 3, 3, 0.8, 0.3, t_grid)
    assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a))
