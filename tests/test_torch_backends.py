"""The port's data-driven amplitude backends against the JAX package.

`models/amplitude_backends.py`: the Interp2D grid and its evaluation, the
ROMAN network's initial draws, forward pass and Adam fit, and the
reference-signature facades, on seeded numpy inputs, on the CPU; then the
JAX package's own backend tests (tests/test_amplitude.py:268-330,
tests/test_rwz_calibration.py:158-190) mirrored on the port at their sizes.

Tolerances. The grids tabulate float32 amplitude projections, summed in
another order in each package: 2e-5 of the largest mode at each grid point,
the bound tests/test_torch_rwz.py holds the full-fidelity amplitudes to
(2e-5 of the family's projection floor). Everything on float64
tensors (the interpolation of one carried grid, the network's forward pass
on carried weights): 1e-12 relative. The weights' draws: bit for bit. The
Adam fit on an analytic source both packages evaluate alike: 1e-9 relative
after 20 steps (float64 gradients reduced in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import amplitude_backends as j_back
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude as t_amp
from emri_frequencydomainwaveforms_tpu_torch.models import amplitude_backends as t_back


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(n_max, l_max=6):
    j = j_amp.default_mode_table(n_max, l_max=l_max)
    return j, convert.mode_table_from_numpy(j.ls, j.ms, j.ns)


def _orbits(seed, n):
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.02, 0.6, n)
    p = 6.0 + 2.0 * e + rng.uniform(0.6, 9.0, n)
    return p, e


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


@pytest.mark.parametrize("rung", ["flat", "full_fidelity"])
def test_grid_matches_reference(rung):
    jt, tt = _tables(4, l_max=3)
    kw = dict(n_u=20, n_e=11, e_range=(1e-6, 0.6))
    j_src = j_amp.mode_amplitudes if rung == "flat" else j_amp.full_fidelity_amplitudes
    t_src = t_amp.mode_amplitudes if rung == "flat" else t_amp.full_fidelity_amplitudes
    ref = j_back.build_amplitude_grid(jt, source=j_src, **kw)
    got = t_back.build_amplitude_grid(tt, source=t_src, device="cpu", **kw)
    assert (got.u0, got.du, got.e0, got.de) == (ref.u0, ref.du, ref.e0, ref.de)
    assert got.values.shape == ref.values.shape == (20, 11, jt.num_modes, 2)
    assert got.values.dtype == torch.float64 and got.values.device.type == "cpu"
    a = np.asarray(ref.values)
    per_point = np.max(np.abs(a), axis=(2, 3), keepdims=True)
    assert np.max(np.abs(got.values.numpy() - a) / per_point) <= 2e-5


# the main path's 16 frozen slots (the eps selection at the rwz source, 1 yr)
FROZEN = [(2, 1, 0), (2, 2, -1), (2, 1, 1), (2, 2, 0), (3, 3, -1), (2, 2, 1), (2, 2, 2), (3, 3, 1),
          (2, 2, 3), (3, 3, 2), (2, 2, 4), (3, 3, 3), (2, 2, 5), (3, 3, 4), (2, 2, -2), (3, 3, 5)]


def test_full_table_grid_float32_noise():
    """The production grid (the l <= 6, |n| <= 30 table at the default
    64 x 33 size, full fidelity): the high-l, high-n harmonics at high e
    carry float32 projection noise of up to ~2e-3 of a point's largest mode
    in either package, so the grids are compared per point by the relative
    L2 over all modes (<= 5e-3), and on the main path's 16 frozen slots by
    each point's largest of them (<= 1e-4). chip_smoke.py holds the card's
    grid to the CPU's with the same two bounds."""
    jt, tt = _tables(30)
    ref = np.asarray(j_back.build_amplitude_grid(jt, source=j_amp.full_fidelity_amplitudes).values)
    got = t_back.build_amplitude_grid(tt, source=t_amp.full_fidelity_amplitudes,
                                      device="cpu").values.numpy()
    d = np.hypot(got[..., 0] - ref[..., 0], got[..., 1] - ref[..., 1])
    a = np.hypot(ref[..., 0], ref[..., 1])
    per_point = np.sqrt((d**2).sum(-1) / (a**2).sum(-1)).max()
    lookup = {lmn: i for i, lmn in enumerate(zip(jt.ls.tolist(), jt.ms.tolist(), jt.ns.tolist()))}
    idx = [lookup[lmn] for lmn in FROZEN]
    frozen = (d[..., idx] / a[..., idx].max(-1, keepdims=True)).max()
    print(f"full-table grid, port vs reference: per-point rel L2 {per_point:.3e}, frozen slots "
          f"{frozen:.3e}")
    assert per_point <= 5e-3 and frozen <= 1e-4


def test_carried_grid_interpolates_as_reference():
    jt, _ = _tables(4, l_max=3)
    ref = j_back.build_amplitude_grid(jt, n_u=20, n_e=11)
    grid = convert.amplitude_grid_from_numpy(
        ref._replace(values=np.asarray(ref.values), table=(jt.ls, jt.ms, jt.ns)), device="cpu")
    p, e = _orbits(5, 9)
    jr, ji = j_back.mode_amplitudes_interp2d(jnp.asarray(p), jnp.asarray(e), ref)
    tr, ti = t_back.mode_amplitudes_interp2d(p, e, grid)
    assert tr.shape == (9, jt.num_modes)
    assert _rel(jr, tr.numpy()) <= 1e-12 and _rel(ji, ti.numpy()) <= 1e-12


def test_init_roman_network_identical():
    jt, tt = _tables(3, l_max=2)
    ref = j_back.init_roman_network(jt, hidden=(8, 16), seed=4)
    got = t_back.init_roman_network(tt, hidden=(8, 16), seed=4, device="cpu")
    assert len(got.weights) == len(ref.weights) == 3
    for a, b in zip(ref.weights, got.weights):
        assert b.dtype == torch.float64
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(ref.biases, got.biases):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def _perturbed_reference_params(jt):
    ref = j_back.init_roman_network(jt, hidden=(16, 16), seed=9)
    rng = np.random.default_rng(12)
    biases = tuple(jnp.asarray(rng.normal(0, 0.3, np.shape(b))) for b in ref.biases)
    scale = jnp.asarray(rng.uniform(0.5, 2.0, np.shape(ref.scale)))
    return ref._replace(biases=biases, scale=scale)


def _carry(params, jt):
    return convert.roman_params_from_numpy(dict(
        weights=[np.asarray(w) for w in params.weights],
        biases=[np.asarray(b) for b in params.biases],
        table=(jt.ls, jt.ms, jt.ns), scale=np.asarray(params.scale)), device="cpu")


def test_roman_forward_matches_reference():
    jt, _ = _tables(3, l_max=2)
    ref = _perturbed_reference_params(jt)
    got = _carry(ref, jt)
    p, e = _orbits(21, 33)
    jr, ji = j_back.roman_forward(ref, jnp.asarray(p), jnp.asarray(e))
    tr, ti = t_back.roman_forward(got, p, e)
    assert tr.dtype == torch.float64 and tr.shape == (33, jt.num_modes)
    assert _rel(jr, tr.numpy()) <= 1e-12 and _rel(ji, ti.numpy()) <= 1e-12


def _analytic_source(xp):
    """A smooth per-mode amplitude both packages evaluate alike."""
    def source(p, e, table):
        k = xp.asarray(np.arange(1, table.num_modes + 1, dtype=np.float64))
        re = xp.sin(0.3 * k * p[..., None]) * xp.exp(-e[..., None] * k) / p[..., None]
        im = xp.cos(0.2 * k * p[..., None]) * (1.0 + e[..., None]) / (k * p[..., None])
        return re, im
    return source


def test_fit_roman_network_matches_reference():
    jt, tt = _tables(2, l_max=2)
    kw = dict(n_steps=20, batch=64, lr=3e-3, seed=5)
    ref = j_back.fit_roman_network(j_back.init_roman_network(jt, hidden=(16, 16), seed=1),
                                   source=_analytic_source(jnp), **kw)
    got = t_back.fit_roman_network(t_back.init_roman_network(tt, hidden=(16, 16), seed=1,
                                                             device="cpu"),
                                   source=_analytic_source(torch), **kw)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale), rtol=1e-12)
    start = t_back.init_roman_network(tt, hidden=(16, 16), seed=1, device="cpu")
    moved = max(float((a - b).abs().max()) for a, b in zip(got.weights, start.weights))
    assert moved > 1e-3  # 20 Adam steps of lr 3e-3 do move the weights
    for a, b in zip(ref.weights + ref.biases, got.weights + got.biases):
        assert not b.requires_grad
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9, atol=1e-12)


# ---- the reference's own backend tests, on the port ----


def test_interp2d_matches_direct():
    _, tt = _tables(6)
    grid = t_back.build_amplitude_grid(tt, n_u=96, n_e=49, device="cpu")
    ps = torch.tensor([8.0, 10.0, 12.0], dtype=torch.float64)
    es = torch.tensor([0.15, 0.3, 0.45], dtype=torch.float64)
    re_g, im_g = t_back.mode_amplitudes_interp2d(ps, es, grid)
    re_d, im_d = t_amp.mode_amplitudes(ps, es, tt)
    scale = float(re_d.abs().max())
    np.testing.assert_allclose(re_g.numpy(), re_d.numpy(), atol=2e-3 * scale)
    np.testing.assert_allclose(im_g.numpy(), im_d.numpy(), atol=2e-3 * scale)


def test_roman_network_learns():
    _, tt = _tables(3)
    params0 = t_back.init_roman_network(tt, hidden=(32, 32), seed=0, device="cpu")
    params = t_back.fit_roman_network(params0, n_steps=300, batch=192, seed=2)
    ps = torch.tensor([9.0, 11.0], dtype=torch.float64)
    es = torch.tensor([0.2, 0.4], dtype=torch.float64)
    re_d, im_d = t_amp.mode_amplitudes(ps, es, tt)
    scale = float(re_d.abs().max())

    def err(pr):
        re_n, im_n = t_back.roman_forward(pr, ps, es)
        return max(float((re_n - re_d).abs().max()), float((im_n - im_d).abs().max()))

    assert err(params) < 0.25 * err(params0._replace(scale=params.scale))
    assert err(params) < 0.25 * scale


def test_backend_facades_and_conjugate_rule():
    jt, tt = _tables(3)
    ref_grid = j_back.build_amplitude_grid(jt, n_u=48, n_e=25)
    grid = convert.amplitude_grid_from_numpy(
        ref_grid._replace(values=np.asarray(ref_grid.values), table=(jt.ls, jt.ms, jt.ns)),
        device="cpu")
    modes = [(2, 2, 0), (2, -2, 0), (3, -1, 2), (3, 1, -2)]
    p, e = np.array([10.0, 8.5]), np.array([0.3, 0.1])
    params = _perturbed_reference_params(jt)
    for ref_amp, amp in (
        (j_back.Interp2DAmplitude(ref_grid), t_back.Interp2DAmplitude(grid)),
        (j_back.RomanAmplitude(params), t_back.RomanAmplitude(_carry(params, jt))),
    ):
        out, ref = amp(p, e, specific_modes=modes), ref_amp(p, e, specific_modes=modes)
        assert list(out) == modes
        for lmn in modes:
            assert isinstance(out[lmn], np.ndarray) and out[lmn].dtype == np.complex128
            np.testing.assert_allclose(out[lmn], ref[lmn], rtol=1e-12)
        # A_{l,-m,-n} = (-1)^l conj(A_{l,m,n}), exactly
        np.testing.assert_array_equal(out[(2, -2, 0)], np.conj(out[(2, 2, 0)]))
        np.testing.assert_array_equal(out[(3, -1, 2)], -np.conj(out[(3, 1, -2)]))
        assert len(amp(p, e)) == jt.num_modes


def test_roman_amplitude_module_holds_float64_parameters():
    _, tt = _tables(2, l_max=2)
    module = t_back.RomanAmplitude(t_back.init_roman_network(tt, hidden=(8,), device="cpu"))
    params = list(module.parameters())
    assert len(params) == 4 and all(isinstance(w, torch.nn.Parameter) for w in params)
    assert all(w.dtype == torch.float64 for w in params)
    assert set(module.state_dict()) == {"weights.0", "weights.1", "biases.0", "biases.1", "scale"}
    p, e = torch.tensor([9.0]), torch.tensor([0.2])
    re, im = t_back.roman_forward(module.params, p, e)
    i = list(zip(tt.ls.tolist(), tt.ms.tolist(), tt.ns.tolist())).index((2, 2, 0))
    got = module(p, e, specific_modes=[(2, 2, 0)])[(2, 2, 0)]
    np.testing.assert_array_equal(got, (re[..., i] + 1j * im[..., i]).detach().numpy())


def test_interp2d_grid_carries_full_fidelity_source():
    _, tt = _tables(4, l_max=2)
    grid = t_back.build_amplitude_grid(tt, n_u=48, n_e=17, e_range=(1e-6, 0.6),
                                       source=t_amp.full_fidelity_amplitudes, device="cpu")
    p = torch.tensor([8.5, 11.0], dtype=torch.float64)
    e = torch.tensor([0.25, 0.4], dtype=torch.float64)
    gr, gi = t_back.mode_amplitudes_interp2d(p, e, grid)
    dr, di = t_amp.full_fidelity_amplitudes(p, e, tt)
    mag = (dr.abs() + di.abs()).numpy()
    scale = np.maximum(mag, mag.max() * 1e-3)
    err = ((gr - dr).abs() + (gi - di).abs()).numpy() / scale
    dominant = mag > 0.1 * mag.max()
    assert float(err[dominant].max()) < 2e-3
    assert float(err.max()) < 5e-2
