"""Parity of the PyTorch port's amplitudes and mode selection with JAX.

The flat multipole amplitudes are a float32 projection in both packages; the
two accumulate the 256-node projection sums in different orders, so the
Fourier coefficients agree to ~1e-6 of each family's largest coefficient
(and the amplitudes to that level times omega_mn^l). Mode selection must pick
identical indices, including under ties.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import modeselect as j_sel
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude as t_amp
from emri_frequencydomainwaveforms_tpu_torch.models import modeselect as t_sel


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def orbits():
    rng = np.random.default_rng(31)
    e = rng.uniform(0.05, 0.5, (2, 5))
    p = 6.0 + 2.0 * e + rng.uniform(1.0, 8.0, (2, 5))
    return p, e


def test_families_copy_equals_reference():
    assert t_amp._FAMILIES == j_amp._FAMILIES
    assert list(t_amp._FAMILIES) == list(j_amp._FAMILIES)
    for n_max, l_max in ((30, 6), (16, 2), (8, 10)):
        ref = j_amp.default_mode_table(n_max, l_max=l_max)
        got = t_amp.default_mode_table(n_max, l_max=l_max)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


def test_orbit_harmonics(orbits):
    p, e = orbits
    fam = (0, 1, 2, 5, 10, 18)
    fj, opj, orj = j_amp._orbit_harmonics(jnp.asarray(p), jnp.asarray(e), 30, fam)
    ft, opt, ort = t_amp._orbit_harmonics(torch.from_numpy(p), torch.from_numpy(e), 30, fam)
    fj = np.asarray(fj)
    assert ft.dtype == torch.float32 and ft.shape == fj.shape
    scale = np.abs(fj).max(axis=-1, keepdims=True)
    assert np.max(np.abs(fj - ft.numpy()) / scale) < 3e-6
    for a, b in ((opj, opt), (orj, ort)):
        assert np.max(np.abs(np.asarray(a) - b.numpy()) / np.asarray(a)) < 1e-6


def test_mode_amplitudes_flat(orbits):
    p, e = orbits
    table = j_amp.default_mode_table(30)
    ar, ai = j_amp.mode_amplitudes(jnp.asarray(p), jnp.asarray(e), table)
    tt = t_amp.ModeTable(*table)
    br, bi = t_amp.mode_amplitudes(torch.from_numpy(p), torch.from_numpy(e), tt)
    assert br.dtype == torch.float64 and br.shape == ar.shape
    # each mode's error against its family's projection noise floor
    # |C_lm| |omega_mn|^l max_n |F_n| (the amplitude is C omega^l F_n): the
    # ~1e-6 of the projection sums plus the float32 Omega_phi / Omega_r
    # (~1e-7 apart), which omega_mn^l amplifies where omega_mn nearly cancels
    f_fam, om_phi, om_r = j_amp._orbit_harmonics(jnp.asarray(p), jnp.asarray(e), 30)
    f_max = np.abs(np.asarray(f_fam)).max(axis=-1)  # (..., families)
    fam_idx = np.array([j_amp._FAMILY_ORDER.index((l, m)) for l, m in zip(table.ls, table.ms)])
    c_abs = np.array([np.hypot(*j_amp._FAMILIES[(l, m)][3:]) for l, m in zip(table.ls, table.ms)])
    om = table.ms * np.asarray(om_phi)[..., None] + table.ns * np.asarray(om_r)[..., None]
    floor = c_abs * np.abs(om) ** table.ls * f_max[..., fam_idx]
    err = np.hypot(np.asarray(ar) - br.numpy(), np.asarray(ai) - bi.numpy())
    assert np.max(err / floor) < 1e-5
    # precomputed family constants give the same result
    cr, ci = t_amp.mode_amplitudes(
        torch.from_numpy(p), torch.from_numpy(e), tt,
        family_c=torch.from_numpy(t_amp.family_constants(tt)),
    )
    assert torch.equal(cr, br) and torch.equal(ci, bi)
    # the rwz rung only composes on top of the other two (the rungs
    # themselves are held against the reference in tests/test_torch_rwz.py)
    with pytest.raises(ValueError):
        t_amp.mode_amplitudes(torch.from_numpy(p), torch.from_numpy(e), tt, rwz=True)


def test_mode_power_and_selection():
    rng = np.random.default_rng(32)
    n_b, k, m = 3, 20, 40
    a_re, a_im = rng.standard_normal((2, n_b, k, m))
    y = rng.standard_normal((4, n_b, m))
    w = (rng.random((n_b, k)) > 0.2).astype(np.float64)
    got = t_sel.mode_power(*(torch.from_numpy(x) for x in (a_re, a_im, *y)),
                           dt_weights=torch.from_numpy(w))
    for i in range(n_b):
        ref = j_sel.mode_power(jnp.asarray(a_re[i]), jnp.asarray(a_im[i]),
                               *(jnp.asarray(x[i]) for x in y), dt_weights=jnp.asarray(w[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-13)

    # ties (repeated powers, zero-power candidates) and the order key
    power = rng.choice([0.0, 1.0, 2.0, 3.5], size=(n_b, m)) * rng.choice([1.0, 1.0, 1e-3], size=(n_b, m))
    key = rng.choice([0.5, 1.0, 2.0], size=(n_b, m))
    for eps, with_key in ((1e-2, True), (0.3, True), (1e-2, False)):
        got = t_sel.select_modes(torch.from_numpy(power), 16, eps,
                                 order_key=torch.from_numpy(key) if with_key else None)
        for i in range(n_b):
            ref = j_sel.select_modes(jnp.asarray(power[i]), 16, eps,
                                     order_key=jnp.asarray(key[i]) if with_key else None)
            np.testing.assert_array_equal(got.idx[i].numpy(), np.asarray(ref.idx))
            np.testing.assert_array_equal(got.mask[i].numpy(), np.asarray(ref.mask))
            np.testing.assert_array_equal(got.power[i].numpy(), np.asarray(ref.power))
