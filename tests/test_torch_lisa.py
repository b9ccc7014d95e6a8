"""The PyTorch port's LISA layer against the JAX package.

Sensitivity curves, FD noise, inner products and the whitened likelihood,
on the same seeded inputs in both packages. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.lisa import diagnostic as j_diag
from emri_frequencydomainwaveforms_tpu.lisa import likelihood as j_like
from emri_frequencydomainwaveforms_tpu.lisa import noise as j_noise
from emri_frequencydomainwaveforms_tpu.lisa import sensitivity as j_sens
from emri_frequencydomainwaveforms_tpu.utils.transform import TransformContainer as JTransform
from emri_frequencydomainwaveforms_tpu_torch.lisa import diagnostic as t_diag
from emri_frequencydomainwaveforms_tpu_torch.lisa import likelihood as t_like
from emri_frequencydomainwaveforms_tpu_torch.lisa import noise as t_noise
from emri_frequencydomainwaveforms_tpu_torch.lisa import sensitivity as t_sens
from emri_frequencydomainwaveforms_tpu_torch.utils.transform import TransformContainer as TTransform

F_LOG = np.logspace(-5, 0, 400)


@pytest.mark.parametrize("name", sorted(j_sens._SENS_FNS))
def test_get_sensitivity_every_curve(name):
    # rtol 1e-12 against the reference's float64 numpy evaluation, for numpy
    # and for float64 tensor frequencies, with every return type
    for rt in ("PSD", "ASD", "char_strain"):
        ref = np.asarray(j_sens.get_sensitivity(F_LOG, sens_fn=name, return_type=rt))
        got_np = t_sens.get_sensitivity(F_LOG, sens_fn=name, return_type=rt)
        got_t = t_sens.get_sensitivity(torch.from_numpy(F_LOG), sens_fn=name, return_type=rt)
        assert isinstance(got_np, np.ndarray) and got_t.dtype == torch.float64
        np.testing.assert_allclose(got_np, ref, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-12, atol=0)
    # the PSD keywords and the helpers the dispatcher does not name
    for t_obs in (0.5, 1.0, 4.0):
        np.testing.assert_allclose(t_sens.cornish_lisa_psd(F_LOG, t_obs_years=t_obs),
                                   j_sens.cornish_lisa_psd(F_LOG, t_obs_years=t_obs), rtol=1e-12)
    x, y, z = np.random.default_rng(0).normal(size=(3, 8))
    for a, b in zip(t_sens.AET(x, y, z), j_sens.AET(x, y, z)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_generate_noise_fd_identical():
    f = np.linspace(1e-4, 1e-2, 300)
    for seed in (0, 17):
        ref = j_noise.generate_noise_fd(f, sens_fn="cornish_lisa_psd", seed=seed)
        got = t_noise.generate_noise_fd(f, sens_fn="cornish_lisa_psd", seed=seed)
        np.testing.assert_array_equal(got, ref)


def test_inner_products():
    # tolerance 1e-12 relative, FD inputs with named and callable PSDs and
    # TD inputs
    rng = np.random.default_rng(3)
    f = np.linspace(2e-4, 2e-2, 500)
    a = [rng.normal(size=500) + 1j * rng.normal(size=500) for _ in range(2)]
    b = [x + 0.1 * (rng.normal(size=500) + 1j * rng.normal(size=500)) for x in a]
    psd = lambda ff: j_sens.cornish_lisa_psd(np.asarray(ff))  # noqa: E731
    for kw in (dict(f_arr=f), dict(f_arr=f, PSD="cornish_lisa_psd"), dict(f_arr=f, PSD=psd),
               dict(f_arr=f, df=f[1] - f[0])):
        for fn in ("inner_product", "overlap", "get_mismatch", "snr"):
            ref = getattr(j_diag, fn)(a, b, **kw)
            got = getattr(t_diag, fn)(a, b, **kw)
            assert abs(got - ref) <= 1e-12 * abs(ref)
        ref = j_diag.snr(a, **kw)
        assert abs(t_diag.snr(a, **kw) - ref) <= 1e-12 * ref
        ref_s, ref_fac = j_diag.scale_snr(20.0, a, **kw)
        got_s, got_fac = t_diag.scale_snr(20.0, a, **kw)
        assert abs(got_fac - ref_fac) <= 1e-12 * ref_fac
    td = [rng.normal(size=400), rng.normal(size=400)]
    td2 = [x + 0.3 * rng.normal(size=400) for x in td]
    ref = j_diag.inner_product(td, td2, dt=10.0, PSD="cornish_lisa_psd")
    got = t_diag.inner_product(td, td2, dt=10.0, PSD="cornish_lisa_psd")
    assert abs(got - ref) <= 1e-12 * abs(ref)


NF = 600
_RNG = np.random.default_rng(21)
_BASIS = _RNG.normal(size=(2, 2, 2, NF)) * 1e-20  # (channel, re/im, term, nf)


def _j_template(p):
    """Fixed spectra weighted by the (transformed) parameters, one walker."""
    return [(p[0] * _BASIS[c, 0, 0] + p[2] * _BASIS[c, 0, 1],
             p[0] * _BASIS[c, 1, 0] - p[2] * _BASIS[c, 1, 1]) for c in range(2)]


def _t_template(p):
    """The same, batched: (n, 3) -> (n, NF) channels."""
    basis = torch.from_numpy(_BASIS)
    return [(p[:, :1] * basis[c, 0, 0] + p[:, 2:3] * basis[c, 0, 1],
             p[:, :1] * basis[c, 1, 0] - p[:, 2:3] * basis[c, 1, 1]) for c in range(2)]


def _transforms():
    fill = {"ndim_full": 3, "fill_values": np.array([0.5]), "fill_inds": np.array([1])}
    j = JTransform({0: lambda x: jnp.exp(x)}, fill)
    t = TTransform({0: lambda x: torch.exp(x)}, fill)
    return j, t


def test_likelihood_on_carried_templates():
    # log L, <d|h> and <h|h> within 1e-10 relative of the reference; noise
    # added from a seed identical; subset chunking equal to the whole batch
    f = np.linspace(1e-4, 5e-3, NF)
    truth = np.array([0.2, 1.5])
    j_tr, t_tr = _transforms()
    data = [np.asarray(re) + 1j * np.asarray(im)
            for re, im in _j_template(np.asarray(j_tr.both_transforms(jnp.asarray(truth[None]))[0]))]
    noise = lambda ff: np.asarray(j_sens.cornish_lisa_psd(np.asarray(ff)))  # noqa: E731
    walkers = truth + np.random.default_rng(1).normal(0, 0.05, (7, 2))

    like_j = j_like.Likelihood(_j_template, 2, f_arr=f, parameter_transforms=j_tr)
    like_j.inject_signal(data, noise_fn=noise)
    ll_j = np.asarray(like_j(jnp.asarray(walkers)))
    dh_j, hh_j = (np.asarray(x) for x in like_j.d_h_h_h(jnp.asarray(walkers)))
    for subset in (None, 3):
        like_t = t_like.Likelihood(_t_template, 2, f_arr=f, parameter_transforms=t_tr,
                                   subset=subset, device="cpu")
        like_t.inject_signal(data, noise_fn=noise)
        ll_t = like_t(walkers)
        assert ll_t.dtype == torch.float64 and ll_t.shape == (7,)
        np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-10, atol=0)
        np.testing.assert_allclose(like_t.d_h.numpy(), dh_j, rtol=1e-10)
        np.testing.assert_allclose(like_t.h_h.numpy(), hh_j, rtol=1e-10)
        if subset is None:
            whole = ll_t
        else:
            np.testing.assert_array_equal(ll_t.numpy(), whole.numpy())
    assert abs(float(like_t(truth)[0])) < 1e-12  # zero residual at the injection
    np.testing.assert_array_equal(t_like.df_vector(f), np.asarray(j_like.df_vector(f)))

    # Gaussian noise from a seed: the same whitened data
    like_j.inject_signal(data, noise_fn=noise, add_noise=True, seed=4)
    like_t.inject_signal(data, noise_fn=noise, add_noise=True, seed=4)
    for (a_re, a_im), (b_re, b_im) in zip(like_j.injection_whitened, like_t.injection_whitened):
        np.testing.assert_array_equal(b_re.numpy(), np.asarray(a_re))
        np.testing.assert_array_equal(b_im.numpy(), np.asarray(a_im))
    np.testing.assert_allclose(like_t(walkers).numpy(), np.asarray(like_j(jnp.asarray(walkers))),
                               rtol=1e-10)


def test_sensitivity_from_table(tmp_path):
    # a user's 2-column (f, Sh) table, natural cubic in log-log in both
    # packages: rtol 1e-10 between the knots
    f_tab = np.logspace(-5, 0, 60)
    path = tmp_path / "sh.txt"
    np.savetxt(path, np.column_stack([f_tab, j_sens.cornish_lisa_psd(f_tab)]))
    f = np.logspace(-4.9, -0.1, 300)
    ref = np.asarray(j_sens.sensitivity_from_table(str(path))(f))
    np.testing.assert_allclose(t_sens.sensitivity_from_table(str(path))(f), ref, rtol=1e-10)
