"""The PyTorch port's sampler against the JAX package.

Priors, transforms and periodic helpers on the same inputs; the stretch
update and the swap cascade fed the exact draws the JAX moves make from a
given key (rebuilt here with ``jax.random`` and the moves' own split
structure); the ladder and its adaptation; the sampler's statistics on the
reference's own toy posteriors; the chain backends, including a chain file
written by the JAX package's HDF backend. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import prior as j_prior
from emri_frequencydomainwaveforms_tpu.inference.backends.hdf import HDFBackend as JHDF
from emri_frequencydomainwaveforms_tpu.inference.moves import stretch as j_stretch
from emri_frequencydomainwaveforms_tpu.inference.moves import tempering as j_temp
from emri_frequencydomainwaveforms_tpu.inference.state import make_state as j_make_state
from emri_frequencydomainwaveforms_tpu.utils.periodic import PeriodicContainer as JPeriodic
from emri_frequencydomainwaveforms_tpu.utils.transform import TransformContainer as JTransform
from emri_frequencydomainwaveforms_tpu_torch.inference import prior as t_prior
from emri_frequencydomainwaveforms_tpu_torch.inference.backends.hdf import HDFBackend
from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import GaussianMove
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import stretch as t_stretch
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import tempering as t_temp
from emri_frequencydomainwaveforms_tpu_torch.inference.state import make_state
from emri_frequencydomainwaveforms_tpu_torch.utils.periodic import PeriodicContainer as TPeriodic
from emri_frequencydomainwaveforms_tpu_torch.utils.transform import TransformContainer as TTransform

NDIM = 3
SIGMA = 0.5
MEANS = np.array([1.0, -0.5, 2.0])


def _ll_t(x):
    return -0.5 * torch.sum((x - torch.from_numpy(MEANS)) ** 2, dim=-1) / SIGMA**2


def _ll_j(x):
    return -0.5 * jnp.sum((x - jnp.asarray(MEANS)) ** 2, axis=-1) / SIGMA**2


def _priors(mod, lo=-10.0, hi=10.0):
    return mod.ProbDistContainer({i: mod.uniform_dist(lo, hi) for i in range(NDIM)})


def test_priors_transforms_periodic():
    # tolerance 1e-14 absolute
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 12, (50, 4))
    dists = {0: (j_prior.uniform_dist(0, 10), t_prior.uniform_dist(0, 10)),
             1: (j_prior.log_uniform(0.1, 10), t_prior.log_uniform(0.1, 10)),
             2: (j_prior.MappedUniformDistribution(-1, 3), t_prior.MappedUniformDistribution(-1, 3)),
             3: (j_prior.uniform_dist(1, 2), t_prior.uniform_dist(1, 2))}
    pj = j_prior.ProbDistContainer({k: v[0] for k, v in dists.items()})
    pt = t_prior.ProbDistContainer({k: v[1] for k, v in dists.items()})
    np.testing.assert_allclose(pt.logpdf(x).numpy(), np.asarray(pj.logpdf(jnp.asarray(x))),
                               rtol=0, atol=1e-14)
    for k, (dj, dt) in dists.items():
        np.testing.assert_allclose(dt.logpdf(x[:, k]).numpy(),
                                   np.asarray(dj.logpdf(jnp.asarray(x[:, k]))), rtol=0, atol=1e-14)
    q = rng.uniform(size=(20, 4))
    np.testing.assert_allclose(pt.ppf(q).numpy(), pj.ppf(q), rtol=0, atol=1e-14)
    np.testing.assert_array_equal(pt.rvs(size=(3, 2), random_state=5),
                                  pj.rvs(size=(3, 2), random_state=5))

    fill = {"ndim_full": 6, "fill_values": np.array([0.1, 2.0]), "fill_inds": np.array([1, 4])}
    tj = JTransform({(0, 2): lambda a, b: [jnp.exp(a), jnp.exp(a) * jnp.exp(b)],
                     3: lambda v: v**2}, fill)
    tt = TTransform({(0, 2): lambda a, b: [torch.exp(a), torch.exp(a) * torch.exp(b)],
                     3: lambda v: v**2}, fill)
    p = rng.normal(size=(5, 7, 4))
    np.testing.assert_allclose(tt.both_transforms(p).numpy(),
                               np.asarray(tj.both_transforms(jnp.asarray(p))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tt.both_transforms(p[0], return_transpose=True).numpy(),
                               np.asarray(tj.both_transforms(jnp.asarray(p[0]), return_transpose=True)),
                               rtol=0, atol=1e-14)

    per = {"emri": {1: 2 * np.pi, 3: np.pi}}
    pjc, ptc = JPeriodic(per), TPeriodic(per)
    a, b = rng.uniform(-10, 10, (2, 9, 4))
    for got, ref in ((ptc.distance({"emri": a}, {"emri": b})["emri"],
                      pjc.distance({"emri": a}, {"emri": b})["emri"]),
                     (ptc.wrap({"emri": a})["emri"], pjc.wrap({"emri": a})["emri"]),
                     (ptc.wrap_array("emri", b), pjc.wrap_array("emri", b)),
                     (ptc.distance_array("emri", a, b), pjc.distance_array("emri", a, b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-14)


def test_make_ladder_and_adaptation():
    # make_ladder exact; adapt_ladder 1e-14
    for args in ((6, 5, np.inf), (6, 4, 100.0), (3, None, 50.0), (6, 1, None)):
        np.testing.assert_array_equal(t_temp.make_ladder(*args), j_temp.make_ladder(*args))
    betas = t_temp.make_ladder(6, 5, np.inf)
    swap = np.array([0.3, 0.1, 0.45, 0.2])
    tj = j_temp.TemperatureControl(6, 8, ntemps=5, Tmax=np.inf)
    tt = t_temp.TemperatureControl(6, 8, ntemps=5, Tmax=np.inf)
    for time in (0.0, 7.0, 1e5):
        ref = np.asarray(tj.adapt_ladder(jnp.asarray(betas), jnp.asarray(swap), time))
        got = tt.adapt_ladder(torch.from_numpy(betas), torch.from_numpy(swap), time)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


def _jax_stretch_draws(key, ntemps, nh, a):
    """The draws JAX's StretchMove.propose takes from ``key``, per half."""
    out = []
    for _ in range(2):
        key, k_z, k_c, k_u = jax.random.split(key, 4)
        z = ((a - 1.0) * jax.random.uniform(k_z, (ntemps, nh)) + 1.0) ** 2 / a
        partner = jax.random.randint(k_c, (ntemps, nh), 0, nh)
        u = jax.random.uniform(k_u, (ntemps, nh))
        out.append(tuple(torch.from_numpy(np.array(v)) for v in (z, partner, u)))
    return out


def test_stretch_update_on_jax_draws():
    # identical coords, log-priors and accept counts, log L to 1e-12, with
    # some proposals outside the prior (the prior box cuts the ensemble)
    ntemps, nwalkers = 3, 10
    rng = np.random.default_rng(8)
    coords = rng.normal(MEANS, 0.6, (ntemps, nwalkers, NDIM))
    periods = np.array([0.0, 2 * np.pi, 0.0])
    betas = np.array([1.0, 0.4, 0.0])
    pj, pt = _priors(j_prior, -0.5, 2.5), _priors(t_prior, -0.5, 2.5)
    lp0 = np.array(pj.logpdf(jnp.asarray(coords)))
    ll0 = np.where(np.isfinite(lp0), np.asarray(_ll_j(jnp.asarray(coords))), -1e300)
    key = jax.random.PRNGKey(42)

    move_j = j_stretch.StretchMove(a=2.0, periodic=jnp.asarray(periods))
    ref = move_j.propose(key, jnp.asarray(coords), jnp.asarray(ll0), jnp.asarray(lp0),
                         jnp.asarray(betas), pj.logpdf, _ll_j)
    calls = []

    def logl(x):
        calls.append(x.shape[0])
        return _ll_t(x)

    c, ll, lp = (torch.from_numpy(v) for v in (coords, ll0, lp0))
    acc = torch.zeros((ntemps,), dtype=torch.int64)
    for half, (z, partner, u) in enumerate(_jax_stretch_draws(key, ntemps, nwalkers // 2, 2.0)):
        c, ll, lp, a_h = t_stretch.stretch_half(
            c, ll, lp, torch.from_numpy(betas), half, z, partner, u, pt.logpdf, logl,
            periodic=torch.from_numpy(periods))
        acc = acc + a_h
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ref[1]), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref[3]))
    # the box cuts some proposals, and those are not evaluated
    assert sum(calls) < ntemps * nwalkers


def test_swap_cascade_on_jax_draws():
    # identical coords and swap fractions, log L to 1e-12
    ntemps, nwalkers = 4, 8
    rng = np.random.default_rng(12)
    coords = rng.normal(size=(ntemps, nwalkers, NDIM))
    ll = rng.normal(-5, 3, (ntemps, nwalkers))
    lp = rng.normal(size=(ntemps, nwalkers))
    betas = t_temp.make_ladder(NDIM, ntemps, 20.0)
    key = jax.random.PRNGKey(3)
    tj = j_temp.TemperatureControl(NDIM, nwalkers, ntemps=ntemps, betas=betas)
    ref = tj.temperature_swaps(key, *(jnp.asarray(v) for v in (coords, ll, lp, betas)))
    hot, cold, u = [], [], []
    for _ in range(ntemps - 1):  # the cascade's own split structure
        key, k1, k2, k_u = jax.random.split(key, 4)
        hot.append(torch.from_numpy(np.array(jax.random.permutation(k1, nwalkers))))
        cold.append(torch.from_numpy(np.array(jax.random.permutation(k2, nwalkers))))
        u.append(torch.from_numpy(np.array(jax.random.uniform(k_u, (nwalkers,)))))
    got = t_temp.swap_cascade(*(torch.from_numpy(v) for v in (coords, ll, lp, betas)), hot, cold, u)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert 0 < float(got[3].sum()) < ntemps - 1  # some swaps accepted, some not


def _run(ntemps=1, nwalkers=32, nsteps=400, backend=None, seed=3, burn=50, lo=-10.0):
    sampler = EnsembleSampler(
        nwalkers, [NDIM], _ll_t, {"model_0": _priors(t_prior, lo)},
        tempering_kwargs={"ntemps": ntemps, "Tmax": np.inf} if ntemps > 1 else None,
        backend=backend, seed=seed,
    )
    rng = np.random.default_rng(seed)
    start = rng.normal(MEANS, SIGMA, (ntemps, nwalkers, NDIM))
    if lo == 0.0:
        start = np.abs(start)
    state = sampler.run_mcmc(start, nsteps, burn=burn)
    return sampler, state


def test_sampler_moments_and_tempering():
    # tests/test_inference.py's Gaussian checks at its tolerances
    sampler, _ = _run(ntemps=1, nwalkers=64, nsteps=600)
    flat = sampler.get_chain(discard=100)["model_0"][:, 0, :, 0, :].reshape(-1, NDIM)
    np.testing.assert_allclose(flat.mean(axis=0), MEANS, atol=0.1)
    np.testing.assert_allclose(flat.std(axis=0), SIGMA, rtol=0.15)
    assert 0.2 < sampler.acceptance_fraction.mean() < 0.9

    sampler, _ = _run(ntemps=4, nwalkers=32, nsteps=300)
    chain = sampler.get_chain(discard=50)["model_0"]
    assert chain.shape[1] == 4
    np.testing.assert_allclose(chain[:, 0, :, 0, :].reshape(-1, NDIM).mean(axis=0), MEANS,
                               atol=0.15)
    betas = sampler.backend.get_betas()[-1]
    assert betas[0] == 1.0 and np.all(np.diff(betas) < 0)
    assert np.all(sampler.backend.swap_acceptance_fraction > 0)

    # a prior that excludes part of the posterior: never left
    sampler, _ = _run(ntemps=1, nwalkers=32, nsteps=100, burn=0, lo=0.0)
    assert (sampler.get_chain()["model_0"] >= 0).all()


def test_memory_backend_getters():
    sampler, state = _run(ntemps=2, nwalkers=8, nsteps=12, burn=0, backend=Backend())
    b = sampler.backend
    assert b.iteration == 12
    assert b.get_chain()["model_0"].shape == (12, 2, 8, 1, NDIM)
    assert b.get_chain(discard=2, thin=5)["model_0"].shape == (2, 2, 8, 1, NDIM)
    assert b.get_chain(temp_index=0)["model_0"].shape == (12, 8, 1, NDIM)
    assert b.get_log_like().shape == b.get_log_prior().shape == (12, 2, 8)
    assert b.get_betas().shape == (12, 2)
    assert b.get_inds()["model_0"].all() and (b.get_nleaves()["model_0"] == 1).all()
    np.testing.assert_array_equal(b.get_value("log_like"), b.get_log_like())
    last = b.get_last_sample()
    np.testing.assert_array_equal(last.branches["model_0"].coords.numpy(),
                                  state.branches["model_0"].coords.numpy())
    assert last.random_state == state.random_state
    acc = b.acceptance_fraction
    assert acc.shape == (2, 8) and ((acc >= 0) & (acc <= 1)).all()


def test_hdf_roundtrip_and_exact_resume(tmp_path):
    # 10 steps, reopen, 10 more: the same chain as 20 uninterrupted steps
    full, _ = _run(ntemps=2, nwalkers=8, nsteps=20, burn=0, backend=Backend())
    fn = str(tmp_path / "chain.h5")
    first, _ = _run(ntemps=2, nwalkers=8, nsteps=10, burn=0, backend=HDFBackend(fn))
    again = HDFBackend(fn)
    assert again.initialized and again.iteration == 10
    np.testing.assert_array_equal(again.get_chain()["model_0"], first.get_chain()["model_0"])
    last = again.get_last_sample()
    assert last.branches["model_0"].coords.shape == (2, 8, 1, NDIM)
    resumed = EnsembleSampler(8, [NDIM], _ll_t, {"model_0": _priors(t_prior)},
                              tempering_kwargs={"ntemps": 2, "Tmax": np.inf}, backend=again)
    resumed.run_mcmc(last, 10)
    np.testing.assert_array_equal(again.get_chain()["model_0"], full.get_chain()["model_0"])
    np.testing.assert_array_equal(again.get_log_like(), full.get_log_like())
    np.testing.assert_allclose(again.acceptance_fraction, full.acceptance_fraction, rtol=1e-12)


def test_reads_a_jax_written_chain_file(tmp_path):
    # the JAX package's HDF backend writes 3 iterations; the port reads every
    # dataset back and resumes from the last one
    fn = str(tmp_path / "jax_chain.h5")
    ntemps, nwalkers = 2, 6
    jb = JHDF(fn)
    jb.reset(nwalkers, [NDIM], ntemps=ntemps, branch_names=["emri"])
    rng = np.random.default_rng(2)
    coords = rng.normal(MEANS, SIGMA, (3, ntemps, nwalkers, NDIM))
    for i in range(3):
        st = j_make_state(jnp.asarray(coords[i]),
                          log_like=_ll_j(jnp.asarray(coords[i])),
                          log_prior=jnp.full((ntemps, nwalkers), -3.0),
                          betas=jnp.asarray([1.0, 0.3]), random_state=jax.random.PRNGKey(9 + i),
                          name="emri")
        jb.save_step(st, np.array([2, 3]), swap_frac=np.array([0.5]))
    tb = HDFBackend(fn)
    assert tb.initialized and tb.iteration == 3 and tb.branch_names == ["emri"]
    assert tb.ndims == {"emri": NDIM} and tb.ntemps == ntemps and tb.nwalkers == nwalkers
    np.testing.assert_array_equal(tb.get_chain()["emri"][:, :, :, 0, :], coords)
    np.testing.assert_array_equal(tb.get_log_like(), jb.get_log_like())
    np.testing.assert_array_equal(tb.get_log_prior(), jb.get_log_prior())
    np.testing.assert_array_equal(tb.get_betas(), jb.get_betas())
    np.testing.assert_array_equal(tb.acceptance_fraction, np.asarray(jb.acceptance_fraction))
    last = tb.get_last_sample()
    np.testing.assert_array_equal(last.branches["emri"].coords[:, :, 0].numpy(), coords[-1])
    # the JAX key's two words become the seed of the resumed chain
    words = np.asarray(jax.random.key_data(jax.random.PRNGKey(11)), dtype=np.uint32)
    assert last.random_state == (int(words[0]) << 32) | int(words[1])
    sampler = EnsembleSampler(nwalkers, [NDIM], _ll_t, {"emri": _priors(t_prior)},
                              tempering_kwargs={"ntemps": ntemps, "Tmax": np.inf},
                              branch_names=["emri"], backend=tb)
    sampler.run_mcmc(last, 2)
    assert tb.iteration == 5 and tb.get_chain()["emri"].shape == (5, ntemps, nwalkers, 1, NDIM)
    np.testing.assert_array_equal(tb.get_betas()[2], [1.0, 0.3])


@pytest.mark.parametrize("kw", [dict(nleaves_max=2), dict(rj_moves=True),
                                dict(moves=GaussianMove({"model_0": np.eye(NDIM)}))])
def test_multibranch_configurations_build(kw):
    # each configuration builds what the reference builds: the multi-branch
    # flag, the move and RJ move types and the leaf bounds. nleaves_max = 2
    # and rj_moves run the tree sampler (TreeStretchMove, a prior-draw
    # DistributionGenerateRJ); a covariance per branch on one fixed-dimension
    # branch stays a flat GaussianMove, as in the reference (the tree sampler
    # lifts it: tests/test_torch_tree.py::test_adapt_move)
    from emri_frequencydomainwaveforms_tpu.inference.ensemble import EnsembleSampler as JSampler
    from emri_frequencydomainwaveforms_tpu.inference.moves.gaussian import GaussianMove as JGauss

    def tree_ll_t(c, i):
        return torch.sum(torch.where(i, _ll_t(c), 0.0), dim=-1)

    def tree_ll_j(c, i):
        return jnp.sum(jnp.where(i, _ll_j(c), 0.0), axis=-1)

    tree = "moves" not in kw
    kw_j = {k: JGauss(v.cov_dict) if isinstance(v, GaussianMove) else v for k, v in kw.items()}
    js = JSampler(8, [NDIM], tree_ll_j if tree else _ll_j, {"model_0": _priors(j_prior)}, **kw_j)
    ts = EnsembleSampler(8, [NDIM], tree_ll_t if tree else _ll_t, {"model_0": _priors(t_prior)},
                         **kw)
    assert ts.multibranch == js.multibranch == tree
    assert [type(m).__name__ for m in ts.moves] == [type(m).__name__ for m in js.moves]
    assert [type(m).__name__ for m in ts.rj_moves] == [type(m).__name__ for m in js.rj_moves]
    assert ts.nleaves_max == js.nleaves_max and ts.nleaves_min == js.nleaves_min
    if not tree:
        return
    # two iterations of the tree sampler from one active leaf
    nl = ts.nleaves_max["model_0"]
    coords = np.random.default_rng(6).normal(MEANS, SIGMA, (1, 8, nl, NDIM))
    inds = np.zeros((1, 8, nl), bool)
    inds[..., 0] = True
    last = ts.run_mcmc(make_state({"model_0": coords}, inds={"model_0": inds}), 2)
    counts = ts.get_nleaves()["model_0"]
    assert counts.shape == (2, 1, 8) and counts.min() >= 0 and counts.max() <= nl
    assert torch.isfinite(last.log_like).all()