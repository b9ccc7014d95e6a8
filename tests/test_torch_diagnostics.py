"""The port's sampler diagnostics against the JAX package.

`utils/autocorr.py` function by function on seeded chains; the backend's
autocorrelation time, evidence estimate and acceptance fractions and the
sampler's `get_autocorr_time` / `walkers_independent` on one stored chain
held by both packages, then each package's own short seeded toy run; the
four classes of `inference/stopping.py` through the sampler's hooks; the
plot helpers and `cli/emri_pe.py --plot`.

Tolerance: the estimators are host numpy in both packages, on the same
numbers: equal. The two toy runs draw different random streams (JAX keys,
torch generators), so they are compared through what the chain estimates:
the target's moments and autocorrelation times of the same order.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import prior as j_prior
from emri_frequencydomainwaveforms_tpu.inference import stopping as j_stop
from emri_frequencydomainwaveforms_tpu.inference.backends.memory import Backend as JBackend
from emri_frequencydomainwaveforms_tpu.inference.ensemble import EnsembleSampler as JSampler
from emri_frequencydomainwaveforms_tpu.inference.state import make_state as j_make_state
from emri_frequencydomainwaveforms_tpu.utils import autocorr as j_ac
from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
from emri_frequencydomainwaveforms_tpu_torch.inference import prior as t_prior
from emri_frequencydomainwaveforms_tpu_torch.inference import stopping as t_stop
from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
from emri_frequencydomainwaveforms_tpu_torch.inference.state import make_state
from emri_frequencydomainwaveforms_tpu_torch.utils import autocorr as t_ac
from emri_frequencydomainwaveforms_tpu_torch.utils import plotting

NDIM = 3
SIGMA = 0.5
MEANS = np.array([1.0, -0.5, 2.0])


def _ll_t(x):
    return -0.5 * torch.sum((x - torch.from_numpy(MEANS)) ** 2, dim=-1) / SIGMA**2


def _ll_j(x):
    return -0.5 * jnp.sum((x - jnp.asarray(MEANS)) ** 2, axis=-1) / SIGMA**2


def _priors(mod):
    return mod.ProbDistContainer({i: mod.uniform_dist(-10.0, 10.0) for i in range(NDIM)})


def _ar1(rng, shape, rho=0.8):
    """Correlated series along the first axis (an AR(1) chain per column)."""
    x = np.empty(shape)
    x[0] = rng.standard_normal(shape[1:])
    for i in range(1, shape[0]):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * rng.standard_normal(shape[1:])
    return x


# ---------------------------------------------------------------- autocorr


def test_next_pow_two_and_auto_window():
    for n in (0, 1, 2, 3, 17, 64, 65, 1000):
        assert t_ac.next_pow_two(n) == j_ac.next_pow_two(n)
    taus = np.array([1.0, 1.5, 2.0, 2.2, 2.3, 2.3, 2.3])
    for c in (0.5, 1.0, 2.0, 5.0):
        assert t_ac.auto_window(taus, c) == j_ac.auto_window(taus, c)


@pytest.mark.parametrize("shape", [(500,), (4, 300), (2, 3, 257)])
@pytest.mark.parametrize("norm", [True, False])
def test_acf_batch(shape, norm):
    x = np.random.default_rng(1).standard_normal(shape)
    np.testing.assert_array_equal(t_ac.acf_batch(x, norm=norm), j_ac.acf_batch(x, norm=norm))


def test_single_series_and_walker_estimators():
    rng = np.random.default_rng(2)
    y = _ar1(rng, (400, 16)).T  # (nwalkers, nsteps)
    np.testing.assert_array_equal(t_ac.autocorr_func_1d(y[0]), j_ac.autocorr_func_1d(y[0]))
    with pytest.raises(ValueError):
        t_ac.autocorr_func_1d(y)
    for c in (2.0, 5.0):
        assert t_ac.autocorr_gw2010(y, c=c) == j_ac.autocorr_gw2010(y, c=c)
        assert t_ac.autocorr_new(y, c=c) == j_ac.autocorr_new(y, c=c)
    assert 3.0 < t_ac.autocorr_new(y) < 20.0  # AR(1), rho 0.8: tau = 9


@pytest.mark.parametrize("axis,average", [(0, False), (0, True), (1, False), (-1, True)])
def test_get_acf(axis, average):
    x = _ar1(np.random.default_rng(3), (200, 6, 2))
    np.testing.assert_array_equal(t_ac.get_acf(x, axis=axis, average_walkers=average),
                                  j_ac.get_acf(x, axis=axis, average_walkers=average))


@pytest.mark.parametrize("shape", [(300,), (300, 8), (300, 8, 3), (300, 8, 2, 2)])
def test_get_integrated_act(shape):
    x = _ar1(np.random.default_rng(4), shape)
    np.testing.assert_array_equal(np.asarray(t_ac.get_integrated_act(x)),
                                  np.asarray(j_ac.get_integrated_act(x)))


def test_thermodynamic_integration():
    betas = np.array([1.0, 0.5, 0.2, 0.05])
    logls = np.array([-3.0, -5.0, -11.0, -40.0])
    for b, ll in ((betas, logls), (np.append(betas, 0.0), np.append(logls, -90.0)),
                  (betas[::-1], logls[::-1])):
        got = t_ac.thermodynamic_integration_log_evidence(b, ll)
        ref = j_ac.thermodynamic_integration_log_evidence(b, ll)
        assert got == ref


# ------------------------------------------------ backend and sampler methods


def _stored_chain(nsteps=80, ntemps=3, nwalkers=10):
    rng = np.random.default_rng(5)
    coords = MEANS + SIGMA * _ar1(rng, (nsteps, ntemps, nwalkers, NDIM), rho=0.7)
    betas = np.array([1.0, 0.4, 0.1])
    acc = rng.integers(0, nwalkers, (nsteps, ntemps))
    rj = rng.integers(0, 2, (nsteps, ntemps, nwalkers))
    return coords, betas, acc, rj


def _filled(nsteps=80):
    """The same stored chain in a JAX and a port in-memory backend."""
    coords, betas, acc, rj = _stored_chain(nsteps)
    ntemps, nwalkers = coords.shape[1:3]
    jb, tb = JBackend(), Backend()
    for b in (jb, tb):
        b.reset(nwalkers, [NDIM], ntemps=ntemps, branch_names=["model_0"])
    for i in range(nsteps):
        ll = -0.5 * np.sum((coords[i] - MEANS) ** 2, axis=-1) / SIGMA**2
        jb.save_step(j_make_state(jnp.asarray(coords[i]), log_like=jnp.asarray(ll),
                                  log_prior=jnp.zeros_like(jnp.asarray(ll)),
                                  betas=jnp.asarray(betas), random_state=jax.random.PRNGKey(i)),
                     acc[i], rj_accepted=rj[i])
        tb.save_step(make_state(torch.as_tensor(coords[i]), log_like=torch.as_tensor(ll),
                                log_prior=torch.zeros(ll.shape, dtype=torch.float64),
                                betas=torch.as_tensor(betas), random_state=i),
                     acc[i], rj_accepted=rj[i])
    return jb, tb


def test_backend_diagnostics_match_reference():
    jb, tb = _filled()
    for kw in (dict(), dict(discard=10, thin=2), dict(c=2.0)):
        np.testing.assert_array_equal(tb.get_autocorr_time(**kw)["model_0"],
                                      jb.get_autocorr_time(**kw)["model_0"])
    got, ref = tb.get_evidence_estimate(), jb.get_evidence_estimate()
    assert got == ref and np.isfinite(got[0])
    assert tb.get_evidence_estimate(discard=20, return_error=False) == \
        jb.get_evidence_estimate(discard=20, return_error=False)
    np.testing.assert_array_equal(tb.rj_acceptance_fraction, jb.rj_acceptance_fraction)
    np.testing.assert_array_equal(tb.acceptance_fraction, jb.acceptance_fraction)
    assert tb.rj_acceptance_fraction.shape == (3, 10)


def test_sampler_diagnostics_match_reference():
    jb, tb = _filled()
    js = JSampler(10, [NDIM], _ll_j, {"model_0": _priors(j_prior)},
                  tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=jb)
    ts = EnsembleSampler(10, [NDIM], _ll_t, {"model_0": _priors(t_prior)},
                         tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=tb)
    np.testing.assert_array_equal(ts.get_autocorr_time(discard=5)["model_0"],
                                  js.get_autocorr_time(discard=5)["model_0"])
    assert ts.walkers_independent() is True and bool(js.walkers_independent())
    flat = np.tile(MEANS, (10, 1))
    flat[:, 2] = flat[:, 0] * 2.0  # two parameters move together
    flat[:, 0] += np.linspace(0, 1, 10)
    flat[:, 2] = flat[:, 0] * 2.0
    assert ts.walkers_independent(flat) is False
    assert bool(js.walkers_independent(jnp.asarray(flat))) is False


def test_toy_runs_estimate_alike():
    ts = EnsembleSampler(32, [NDIM], _ll_t, {"model_0": _priors(t_prior)},
                         tempering_kwargs={"ntemps": 2, "Tmax": np.inf}, seed=3)
    js = JSampler(32, [NDIM], _ll_j, {"model_0": _priors(j_prior)},
                  tempering_kwargs={"ntemps": 2, "Tmax": np.inf}, seed=3)
    start = np.random.default_rng(3).normal(MEANS, SIGMA, (2, 32, NDIM))
    ts.run_mcmc(start, 300)
    js.run_mcmc(jnp.asarray(start), 300)
    taus = [s.get_autocorr_time(discard=50)["model_0"] for s in (ts, js)]
    for tau in taus:
        assert tau.shape == (NDIM,) and np.all((tau > 1.0) & (tau < 60.0))
    assert np.all(taus[0] / taus[1] < 3.0) and np.all(taus[1] / taus[0] < 3.0)
    # two rungs (beta 1 and 0): log Z is led by the hot chain's mean log L
    # over the prior, a sample mean with a few percent of spread
    logz = [s.backend.get_evidence_estimate(discard=50)[0] for s in (ts, js)]
    assert np.isfinite(logz).all() and abs(logz[0] - logz[1]) < 0.05 * abs(logz[1])
    assert ts.walkers_independent() is True and bool(js.walkers_independent())


# ---------------------------------------------------------------- stopping


class _Sample:
    def __init__(self, log_like):
        self.log_like = log_like


def test_search_converge_and_snr_stops():
    rng = np.random.default_rng(6)
    series = np.cumsum(rng.uniform(-0.05, 0.2, 40)) - 30.0
    series[25:] = series[24]
    got_s, ref_s = t_stop.SearchConvergeStopping(n_iters=5), j_stop.SearchConvergeStopping(n_iters=5)
    got_n, ref_n = t_stop.SNRStop(20.0), j_stop.SNRStop(20.0)
    for i, best in enumerate(series):
        ll = best - rng.uniform(0, 3, (2, 8))
        ll[0, 0] = best
        assert got_s(i, _Sample(torch.as_tensor(ll)), None) == ref_s(i, _Sample(jnp.asarray(ll)), None)
        assert got_n(i, _Sample(torch.as_tensor(ll)), None) == ref_n(i, _Sample(jnp.asarray(ll)), None)
        assert (got_s.best, got_s.iters_consecutive) == (ref_s.best, ref_s.iters_consecutive)
    assert got_s.iters_consecutive >= 5


def test_autocorrelation_stop_matches_reference():
    jb, tb = _filled()
    js = JSampler(10, [NDIM], _ll_j, {"model_0": _priors(j_prior)},
                  tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=jb)
    ts = EnsembleSampler(10, [NDIM], _ll_t, {"model_0": _priors(t_prior)},
                         tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=tb)
    got, ref = t_stop.AutoCorrelationStop(factor=2.0), j_stop.AutoCorrelationStop(factor=2.0)
    for i in range(2):
        assert got(i, None, ts) == ref(i, None, js)
        assert got.last_tau == ref.last_tau
    assert got(2, None, ts) is True  # 80 steps > 2 tau, and the estimate is stable
    # an empty chain has no estimate: no stop
    empty = EnsembleSampler(10, [NDIM], _ll_t, {"model_0": _priors(t_prior)}, backend=Backend())
    assert t_stop.AutoCorrelationStop()(0, None, empty) is False


def test_adjust_stretch_scale_matches_reference():
    jb, tb = _filled()
    js = JSampler(10, [NDIM], _ll_j, {"model_0": _priors(j_prior)},
                  tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=jb)
    ts = EnsembleSampler(10, [NDIM], _ll_t, {"model_0": _priors(t_prior)},
                         tempering_kwargs={"ntemps": 3, "Tmax": np.inf}, backend=tb)
    got, ref = t_stop.AdjustStretchProposalScale(), j_stop.AdjustStretchProposalScale()
    for i in range(3):
        got(i, None, ts)
        ref(i, None, js)
        assert ts.move.a == js.move.a
    assert ts.move.a != 2.0 and 1.1 <= ts.move.a <= 10.0


def test_hooks_run_through_the_sampler():
    stop = t_stop.SearchConvergeStopping(n_iters=3, diff=1e9)  # never improves enough
    adjust = t_stop.AdjustStretchProposalScale()
    sampler = EnsembleSampler(16, [NDIM], _ll_t, {"model_0": _priors(t_prior)}, seed=4,
                              stopping_fn=stop, stopping_iterations=1,
                              update_fn=adjust, update_iterations=2)
    start = np.random.default_rng(4).normal(MEANS, SIGMA, (1, 16, NDIM))
    sampler.run_mcmc(start, 50)
    # the first check sets the best value, three stalled checks stop the run
    assert sampler.backend.iteration == 4
    assert sampler.move.a != 2.0  # the update hook ran at iteration 2


# ---------------------------------------------------------------- plotting


def test_plot_corner_and_colorplot_write_files(tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(7)
    samples = rng.normal(MEANS, SIGMA, (500, NDIM))
    fname = str(tmp_path / "corner.png")
    fig = plotting.plot_corner(samples, labels=["a", "b", "c"], truths=MEANS, fname=fname)
    assert os.path.getsize(fname) > 1000 and len(fig.axes) == NDIM * NDIM
    plt.close(fig)
    fname = str(tmp_path / "color.png")
    fig = plotting.get_colorplot(samples, samples[:, 0], fname=fname)
    assert os.path.getsize(fname) > 1000
    plt.close(fig)
    fig = plotting.plot_corner(samples[:, :1])  # one parameter: one panel, no file
    assert len(fig.axes) == 1
    plt.close(fig)


def test_emri_pe_plot_writes_the_corner(tmp_path):
    out = str(tmp_path / "pe.h5")
    args = emri_pe.build_parser().parse_args(
        ("-Tobs 0.02 -flux pm -amp flat -kmax 16 -max_steps 128 -nwalkers 4 -ntemps 2 "
         f"-nsteps 2 --plot --outname {out}").split())
    res = emri_pe.run_emri_pe(args, device="cpu", backend=Backend())
    png = out.replace(".h5", "_corner.png")
    assert os.path.getsize(png) > 1000
    assert res["chain"].shape == (2, 2, 4, 1, 6)
