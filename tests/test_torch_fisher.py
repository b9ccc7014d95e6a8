"""The port's Fisher / Cramer-Rao set and relative binning against the JAX package.

`lisa/diagnostic.py`'s Fisher group on the toys of tests/test_lisa.py:108-205
(each case mirrored, and each function held against the JAX one on the same
toy), with waveforms that return numpy arrays or tensors; `lisa/relbin.py`
on the chirp of tests/test_relbin.py (its four cases mirrored, the port's
`logl` and batched call against the JAX ones).

Tolerances. The Fisher set is host numpy float64 in both packages on the
same channels: equal, bit for bit. A waveform whose channels are tensors
(torch's complex exp differs from numpy's in the last bit) goes through
the same stencil in torch, which divides that rounding by eps ~ 1e-6:
1e-9 of the largest derivative, and of sqrt(Gamma_ii Gamma_jj). Relative binning:
the set-up is the same numpy, the per-call core float64 tensors against
jnp (sums in another order): 1e-10 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.lisa import diagnostic as j_diag
from emri_frequencydomainwaveforms_tpu.lisa import relbin as j_relbin
from emri_frequencydomainwaveforms_tpu_torch.lisa import diagnostic as t_diag
from emri_frequencydomainwaveforms_tpu_torch.lisa import relbin as t_relbin

F = np.linspace(1e-3, 1e-2, 300)
G1 = 1e-20 * np.exp(2j * np.pi * F * 5e3)
G2 = 1e-20 * np.exp(2j * np.pi * F * 9e3)
KW = dict(f_arr=F, PSD=lambda ff: np.ones_like(ff) * 1e-45)


def _linear(p):
    # tests/test_lisa.py's model, exactly linear in the parameters
    return [p[0] * G1 + p[1] * G2]


def _chirp_np(p):
    """A nonlinear two-channel toy: amplitude, time shift, phase."""
    h = p[0] * 1e-20 * (F / 1e-3) ** (-7.0 / 6.0) * np.exp(1j * (2 * np.pi * F * p[1] + p[2]))
    return [h, 0.5j * h]


def _chirp_t(p):
    """`_chirp_np` with its channels as complex tensors."""
    f = torch.as_tensor(F)
    h = float(p[0]) * 1e-20 * (f / 1e-3) ** (-7.0 / 6.0) * torch.exp(
        1j * (2 * np.pi * f * float(p[1]) + float(p[2])))
    return [h, 0.5j * h]


P_CHIRP = np.array([3.0, 40.0, 0.7])
EPS_CHIRP = np.array([1e-6, 1e-5, 1e-6])


def test_dh_dlambda_matches_reference():
    for i in range(3):
        ref = j_diag.dh_dlambda(_chirp_np, P_CHIRP, i, EPS_CHIRP[i])
        got = t_diag.dh_dlambda(_chirp_np, P_CHIRP, i, EPS_CHIRP[i])
        on_tensors = t_diag.dh_dlambda(_chirp_t, P_CHIRP, i, EPS_CHIRP[i])
        for a, b, c in zip(ref, got, on_tensors):
            np.testing.assert_array_equal(b, a)
            assert isinstance(c, torch.Tensor)
            assert np.abs(c.numpy() - a).max() <= 1e-9 * np.abs(a).max()


def test_fisher_gaussian_model():
    g = 1e-20 * np.exp(2j * np.pi * F * 5e3)
    unit = dict(f_arr=F, PSD=lambda ff: np.ones_like(ff))
    gamma = t_diag.fisher(lambda p: [p[0] * g], np.array([2.0]), 1e-6, **unit)
    expect = t_diag.inner_product([g], [g], **unit)
    np.testing.assert_allclose(gamma[0, 0], expect, rtol=1e-6)
    np.testing.assert_array_equal(gamma, j_diag.fisher(lambda p: [p[0] * g], np.array([2.0]),
                                                       1e-6, **unit))


def test_fisher_matches_reference_on_arrays_and_tensors():
    ref = j_diag.fisher(_chirp_np, P_CHIRP, EPS_CHIRP, **KW)
    np.testing.assert_array_equal(t_diag.fisher(_chirp_np, P_CHIRP, EPS_CHIRP, **KW), ref)
    on_tensors = t_diag.fisher(_chirp_t, P_CHIRP, EPS_CHIRP, **KW)
    d = np.sqrt(np.diag(ref))
    assert (np.abs(on_tensors - ref) / np.outer(d, d)).max() <= 1e-9
    assert np.all(np.linalg.eigvalsh(ref) > 0)


def test_pinv_highprec_beats_f64_on_scale_disparity():
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    a = q @ np.diag([3.0, 2.0, 1.5, 1.0, 0.5]) @ q.T  # cond 6, SPD
    d = np.diag([1e10, 1e6, 1.0, 1e-4, 1e-4])
    g = d @ a @ d
    exact = np.linalg.inv(d) @ np.linalg.inv(a) @ np.linalg.inv(d)
    hp = t_diag.pinv_highprec(g)
    np.testing.assert_allclose(hp, exact, rtol=1e-8)
    np.testing.assert_array_equal(hp, j_diag.pinv_highprec(g))
    f64 = np.linalg.pinv(g)
    soft_err = np.abs(np.diag(f64)[3:] / np.diag(exact)[3:] - 1.0)
    assert soft_err.max() > 0.9


@pytest.mark.parametrize("precision", [False, True])
def test_covariance_matches_reference(precision):
    got = t_diag.covariance(_chirp_np, P_CHIRP, EPS_CHIRP, diagonalize=True,
                            precision=precision, dps=60, **KW)
    ref = j_diag.covariance(_chirp_np, P_CHIRP, EPS_CHIRP, diagonalize=True,
                            precision=precision, dps=60, **KW)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1][0], ref[1][0])
    gamma = t_diag.fisher(_chirp_np, P_CHIRP, EPS_CHIRP, **KW)
    d = np.sqrt(np.diag(gamma))
    ident = (got[0] * np.outer(d, d)) @ (gamma / np.outer(d, d))
    np.testing.assert_allclose(ident, np.eye(3), atol=1e-8)


def test_eigens_symmetric():
    gamma = t_diag.fisher(_linear, np.array([3.0, 1.5]), 1e-7, **KW)
    w, v = t_diag.get_eigens(gamma)
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, gamma, rtol=1e-8)
    rw, rv = j_diag.get_eigens(gamma)
    np.testing.assert_array_equal(w, rw)
    np.testing.assert_array_equal(v, rv)


def test_single_draw_ratio_near_one():
    p = np.array([3.0, 1.5])
    gamma = t_diag.fisher(_linear, p, 1e-7, **KW)
    mism, ratio = t_diag.vallisneri_criterion(_linear, p, fish=gamma, rng=1, **KW)
    assert 0.0 <= mism < 0.1
    assert abs(np.log(ratio)) < 0.02
    assert (mism, ratio) == j_diag.vallisneri_criterion(_linear, p, fish=gamma, rng=1, **KW)
    # without a Fisher matrix it builds one from eps, and asks for one of the two
    assert t_diag.vallisneri_criterion(_linear, p, eps=1e-7, rng=1, **KW) == \
        j_diag.vallisneri_criterion(_linear, p, eps=1e-7, rng=1, **KW)
    with pytest.raises(ValueError):
        t_diag.vallisneri_criterion(_linear, p, **KW)


def test_cdf_shapes_and_r90():
    p = np.array([3.0, 1.5])
    gamma = t_diag.fisher(_linear, p, 1e-7, **KW)
    r90, quantiles, cdf, ratios = t_diag.vallisneri_criterion_cdf(
        _linear, p, fish=gamma, num_samples=40, return_ratios=True, seed=3, **KW)
    assert ratios.shape == (40,)
    assert len(quantiles) == len(cdf)
    assert np.all(np.diff(cdf) > 0) or len(cdf) == 1
    assert 0.0 <= r90 < 0.05
    assert r90 <= ratios.max() + 1e-15
    ref = j_diag.vallisneri_criterion_cdf(_linear, p, fish=gamma, num_samples=40,
                                          return_ratios=True, seed=3, **KW)
    assert r90 == ref[0]
    for a, b in zip((quantiles, cdf, ratios), ref[1:]):
        np.testing.assert_array_equal(a, b)
    assert t_diag.vallisneri_criterion_cdf(_linear, p, eps=1e-7, num_samples=5,
                                           return_cdf=False, **KW) == \
        j_diag.vallisneri_criterion_cdf(_linear, p, eps=1e-7, num_samples=5, return_cdf=False, **KW)


def test_mismatch_criterion_matches_reference():
    cov = t_diag.covariance(_chirp_np, P_CHIRP, EPS_CHIRP, **KW)
    got = t_diag.mismatch_criterion(_chirp_np, P_CHIRP, cov, n_draws=8, seed=2, **KW)
    ref = j_diag.mismatch_criterion(_chirp_np, P_CHIRP, cov, n_draws=8, seed=2, **KW)
    assert got.shape == (8,) and np.all((got >= 0) & (got < 1))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(
        t_diag.mismatch_criterion(_chirp_t, P_CHIRP, cov, n_draws=8, seed=2, **KW), ref,
        rtol=1e-9, atol=1e-15)


def test_cutler_vallisneri_bias_matches_reference():
    def approx(p):
        h0, h1 = _chirp_np(p)
        return [h0 * (1.0 + 1e-3 * F / 1e-2), h1]

    got, gamma = t_diag.cutler_vallisneri_bias(_chirp_np, approx, P_CHIRP, EPS_CHIRP,
                                               return_fisher=True, **KW)
    ref, ref_gamma = j_diag.cutler_vallisneri_bias(_chirp_np, approx, P_CHIRP, EPS_CHIRP,
                                                   return_fisher=True, **KW)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(gamma, ref_gamma)
    assert np.all(np.isfinite(got)) and abs(got[0]) > 0


# ---------------------------------------------------------------- relbin

FR = np.linspace(1e-3, 2e-2, 40000)
PSD = 1e-40 * (1.0 + (3e-3 / FR) ** 4 + (FR / 1e-2) ** 2)
TRUTH = np.array([1.0, 5e3, 0.8, 2.0])


def _chirp(params, f):
    a, t0, phi0, eta = params
    psi = 2 * np.pi * f * t0 + phi0 + eta * (f / 1e-2) ** (-5.0 / 3.0)
    return a * (f / 1e-2) ** (-7.0 / 6.0) * np.exp(1j * psi) * 1e-19


def _full_logl(params, data):
    resid = data - _chirp(params, FR)
    return float(-0.5 * np.sum(4.0 * (FR[1] - FR[0]) * np.abs(resid) ** 2 / PSD))


@pytest.fixture(scope="module")
def likes():
    """The JAX and the port's likelihoods on the same data and fiducial."""
    data = _chirp(TRUTH, FR)
    h0 = _chirp(TRUTH * (1.0 + 1e-4), FR)
    ref = j_relbin.RelativeBinningLikelihood.__new__(j_relbin.RelativeBinningLikelihood)

    def j_template(params):
        f_e = jnp.asarray(ref.f_edges)
        psi = (2 * np.pi * f_e * params[1] + params[2]
               + params[3] * (f_e / 1e-2) ** (-5.0 / 3.0))
        amp = params[0] * (f_e / 1e-2) ** (-7.0 / 6.0) * 1e-19
        return [(amp * jnp.cos(psi), amp * jnp.sin(psi))]

    j_relbin.RelativeBinningLikelihood.__init__(ref, j_template, FR, [data], [h0], PSD,
                                                max_bins=512)
    got = None

    def t_template(params):
        # (..., 4) walkers -> (re, im) at the bin edges, (..., nbins + 1)
        f_e = got.f_edges_t
        p = torch.as_tensor(params, dtype=torch.float64)[..., None]
        psi = 2 * np.pi * f_e * p[..., 1, :] + p[..., 2, :] + p[..., 3, :] * (f_e / 1e-2) ** (-5.0 / 3.0)
        amp = p[..., 0, :] * (f_e / 1e-2) ** (-7.0 / 6.0) * 1e-19
        return [(amp * torch.cos(psi), amp * torch.sin(psi))]

    got = t_relbin.RelativeBinningLikelihood(t_template, FR, [data], [h0], PSD, max_bins=512,
                                             device="cpu")
    return data, ref, got


def _draws(n):
    rng = np.random.default_rng(3)
    scales = np.array([1e-3, 3e-2, 3e-3, 1e-4]) * np.abs(TRUTH)
    return TRUTH + rng.standard_normal((n, 4)) * scales


def test_edges_shape():
    edges = t_relbin.select_bin_edges(FR, max_bins=128)
    assert 16 <= len(edges) <= 129 + 1
    assert edges[0] == 0 and edges[-1] == len(FR) - 1
    for nb in (16, 128, 512):
        np.testing.assert_array_equal(t_relbin.select_bin_edges(FR, max_bins=nb),
                                      j_relbin.select_bin_edges(FR, max_bins=nb))


def test_matches_full_likelihood(likes):
    data, ref, got = likes
    max_err = spread = 0.0
    for p in _draws(12):
        full = _full_logl(p, data)
        rb = float(got.logl(p))
        max_err = max(max_err, abs(rb - full))
        spread = max(spread, abs(full))
        j = float(ref.logl(jnp.asarray(p)))
        assert abs(rb - j) <= 1e-10 * max(abs(j), 1.0)
    assert spread > 1.0
    assert max_err < 0.02 * spread


def test_exact_at_fiducial_ratio_one(likes):
    data, ref, got = likes
    fid = TRUTH * (1.0 + 1e-4)
    rb = got.logl(torch.as_tensor(fid))
    assert rb.dim() == 0 and rb.dtype == torch.float64
    full = _full_logl(fid, data)
    assert abs(float(rb) - full) < 1e-6 * max(abs(full), 1.0)


def test_batched_call(likes):
    data, ref, got = likes
    batch = np.concatenate([np.stack([TRUTH, TRUTH * (1 + 1e-5)]), _draws(30)])
    out = got(torch.as_tensor(batch))
    assert out.shape == (32,) and out.device.type == "cpu"
    assert torch.isfinite(out).all()
    ref_out = np.asarray(ref(jnp.asarray(batch)))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-10, atol=1e-10)
    # one walker at a time gives the batch's values
    for i in (0, 5, 31):
        assert abs(float(got(batch[i])) - float(out[i])) <= 1e-12 * max(abs(float(out[i])), 1.0)
