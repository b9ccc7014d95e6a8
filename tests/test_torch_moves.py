"""The PyTorch port's move library and move schedule against the JAX package.

Each move is run by both packages on the same seeded inputs: a prior box
that cuts some proposals, a ladder with a beta = 0 rung and a periodic
column. The JAX move runs from a PRNG key op by op, as the reference's
own move tests run it (the group stretch compiled, as the stretch's update
runs compiled inside its scan: the port fuses their multiply-adds as XLA
does); the draws it takes from that key are rebuilt here by replaying its
``jax.random.split`` sequence, and the port's move is applied to them
(``step(..., draws, ...)``). Accept counts and log priors must be
identical, log L within 1e-12 relative; coordinates identical where no
Cholesky factor or matrix product enters the update, else within 1e-12
relative. Then the sampler's schedule (selection, ``move_info``
threading, the refusals) and small-size versions of the reference's own
sampling tests, run with the port's own draws.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import prior as j_prior
from emri_frequencydomainwaveforms_tpu.inference.moves import distgen as j_distgen
from emri_frequencydomainwaveforms_tpu.inference.moves import gaussian as j_gauss
from emri_frequencydomainwaveforms_tpu.inference.moves import gb as j_gb
from emri_frequencydomainwaveforms_tpu.inference.moves import group as j_group
from emri_frequencydomainwaveforms_tpu.inference.moves import mt as j_mt
from emri_frequencydomainwaveforms_tpu.inference.moves import stretch as j_stretch
from emri_frequencydomainwaveforms_tpu_torch.inference import prior as t_prior
from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import (
    CombineMove,
    DelayedRejectionMove,
    DIMEMove,
    DIMEState,
    DistributionGenerate,
    GaussianMove,
    GroupStretchMove,
    MTDistGenMove,
    MultiSourceFisherProposal,
    PTRedBlueMove,
    SkyMove,
    StretchMove,
)
from emri_frequencydomainwaveforms_tpu_torch.inference.moves.stretch import chisquare
from emri_frequencydomainwaveforms_tpu_torch.inference.prior import (
    ProbDistContainer,
    uniform_dist,
)
from emri_frequencydomainwaveforms_tpu_torch.inference.state import make_state

NTEMPS, NWALKERS = 3, 10
BETAS = np.array([1.0, 0.4, 0.0])
SIGMA = 0.5


def _means(ndim):
    return np.linspace(1.0, 2.0, ndim)


def _ll_t(x):
    return -0.5 * torch.sum((x - torch.from_numpy(_means(x.shape[-1]))) ** 2, dim=-1) / SIGMA**2


def _ll_j(x):
    return -0.5 * jnp.sum((x - jnp.asarray(_means(x.shape[-1]))) ** 2, axis=-1) / SIGMA**2


class Case:
    """Seeded walkers around the likelihood's peak; the prior box [0.2, 2.8]
    cuts some of them and some proposals; column 1 has period 2 pi."""

    def __init__(self, ndim=3, seed=8, periodic=True, boxes=None):
        rng = np.random.default_rng(seed)
        self.ndim = ndim
        if boxes is None:
            boxes = [(0.2, 2.8)] * ndim
            self.coords = rng.normal(_means(ndim), 0.6, (NTEMPS, NWALKERS, ndim))
        else:
            # uniform over each box widened by 10 % on both sides
            lo, hi = np.array(boxes).T
            pad = 0.1 * (hi - lo)
            self.coords = rng.uniform(lo - pad, hi + pad, (NTEMPS, NWALKERS, ndim))
        self.pj = j_prior.ProbDistContainer(
            {i: j_prior.uniform_dist(*b) for i, b in enumerate(boxes)})
        self.pt = t_prior.ProbDistContainer(
            {i: t_prior.uniform_dist(*b) for i, b in enumerate(boxes)})
        self.lp = np.array(self.pj.logpdf(jnp.asarray(self.coords)))
        self.ll = np.where(np.isfinite(self.lp), np.asarray(_ll_j(jnp.asarray(self.coords))),
                           -1e300)
        self.periods = np.zeros(ndim)
        if periodic:
            self.periods[1] = 2 * np.pi
        self.calls = []

    def logl_t(self, x):
        self.calls.append(x.shape[0])
        return _ll_t(x)

    def run_jax(self, move, key, compiled=False):
        """The JAX move, op by op or compiled."""
        pj = self.pj

        def f(k, c, ll, lp, b):
            return move.propose(k, c, ll, lp, b, pj.logpdf, _ll_j)

        f = jax.jit(f) if compiled else f
        return [np.asarray(v) for v in f(key, jnp.asarray(self.coords), jnp.asarray(self.ll),
                                         jnp.asarray(self.lp), jnp.asarray(BETAS))]

    def run_port(self, move, draws):
        t = torch.from_numpy
        return move.step(t(self.coords), t(self.ll), t(self.lp), t(BETAS), draws,
                         self.pt.logpdf, self.logl_t)

    def check(self, got, ref, exact_coords=True, cut=True, moves=1):
        if exact_coords:
            np.testing.assert_array_equal(got[0].numpy(), ref[0])
        else:
            np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-12, atol=0)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-12, atol=0)
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
        np.testing.assert_array_equal(got[3].numpy(), ref[3])
        # some walkers accept and some reject
        assert 0 < int(got[3].sum()) < moves * NTEMPS * NWALKERS
        if cut:
            # the box cuts some of the proposals, and those are not evaluated
            assert sum(self.calls) < NTEMPS * NWALKERS * len(self.calls)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mh_draws(key, proposal):
    """MHMove.propose: (proposal draws from k_prop, accept uniforms)."""
    key, k_prop, k_u = jax.random.split(key, 3)
    return proposal(k_prop), _t(jax.random.uniform(k_u, (NTEMPS, NWALKERS)))


def _stretch_draws(key, a, nh):
    out = []
    for _ in range(2):
        key, k_z, k_c, k_u = jax.random.split(key, 4)
        z = jax.jit(lambda k: ((a - 1.0) * jax.random.uniform(k, (NTEMPS, nh)) + 1.0) ** 2 / a)(k_z)
        out.append((_t(z), _t(jax.random.randint(k_c, (NTEMPS, nh), 0, nh)),
                    _t(jax.random.uniform(k_u, (NTEMPS, nh)))))
    return out


def _gaussian_draws(key, mode, ndim):
    def proposal(k):
        if mode == "DE":
            k_pair, k_g, k_n = jax.random.split(k, 3)
            return (_t(jax.random.randint(k_pair, (NTEMPS, NWALKERS), 0, NWALKERS)),
                    _t(jax.random.randint(k_g, (NTEMPS, NWALKERS), 0, NWALKERS)),
                    _t(jax.random.uniform(k_n, (NTEMPS, NWALKERS, 1))))
        return (_t(jax.random.normal(k, (NTEMPS, NWALKERS, ndim))),)

    return _mh_draws(key, proposal)


def _distgen_draws(key, ndim):
    key, k_draw, k_u = jax.random.split(key, 3)
    return (_t(jax.random.uniform(k_draw, (NTEMPS, NWALKERS, ndim))),
            _t(jax.random.uniform(k_u, (NTEMPS, NWALKERS))))


def _group_draws(key, a, nf):
    key, k_z, k_c, k_u = jax.random.split(key, 4)
    z = jax.jit(lambda k: ((a - 1.0) * jax.random.uniform(k, (NTEMPS, NWALKERS)) + 1.0) ** 2 / a)(
        k_z)
    return (_t(z), _t(jax.random.randint(k_c, (NTEMPS, NWALKERS), 0, nf)),
            _t(jax.random.uniform(k_u, (NTEMPS, NWALKERS))))


def _dr_draws(key, ndim):
    key, k1, k2, ku1, ku2 = jax.random.split(key, 5)
    shape = (NTEMPS, NWALKERS, ndim)
    return (_t(jax.random.normal(k1, shape)), _t(jax.random.normal(k2, shape)),
            _t(jax.random.uniform(ku1, shape[:2])), _t(jax.random.uniform(ku2, shape[:2])))


def _mt_draws(key, ndim, j):
    key, k_draw, k_sel, k_u = jax.random.split(key, 4)
    return (_t(jax.random.uniform(k_draw, (NTEMPS, NWALKERS, j, ndim))),
            _t(jax.random.uniform(k_sel, (NTEMPS, NWALKERS, j))),
            _t(jax.random.uniform(k_u, (NTEMPS, NWALKERS))))


def _dime_draws(key, ndim, dft):
    n = NTEMPS * NWALKERS
    key, k_i0, k_i1, k_f, k_sel, k_z, k_chi, k_acc = jax.random.split(key, 8)
    return (_t(jax.random.randint(k_i0, (n,), 1, n)), _t(jax.random.randint(k_i1, (n,), 1, n - 1)),
            _t(jax.random.normal(k_f, (n,))), _t(jax.random.uniform(k_sel, (n,))),
            _t(jax.random.normal(k_z, (n, ndim))), _t(jax.random.chisquare(k_chi, dft, (n,))),
            _t(jax.random.uniform(k_acc, (NTEMPS, NWALKERS))))


def _swap_draws(key, nwalkers, ntemps):
    hot, cold, u = [], [], []
    for _ in range(ntemps - 1):
        key, k1, k2, k_u = jax.random.split(key, 4)
        hot.append(_t(jax.random.permutation(k1, nwalkers)))
        cold.append(_t(jax.random.permutation(k2, nwalkers)))
        u.append(_t(jax.random.uniform(k_u, (nwalkers,))))
    return hot, cold, u


# ---- every move on JAX's draws ----

COVS = {"scalar": 0.09, "diagonal": np.array([0.09, 0.2, 0.05]),
        "full": np.array([[0.09, 0.02, 0.0], [0.02, 0.2, -0.03], [0.0, -0.03, 0.05]])}


@pytest.mark.parametrize("kind", ["scalar", "diagonal", "full", "AM", "DE"])
def test_gaussian_move_on_jax_draws(kind):
    # scalar and DE: identical coords; diagonal, full and AM (a Cholesky
    # factor or a matrix product): coords within 1e-12 relative
    case = Case()
    mode = kind if kind in ("AM", "DE") else "Gaussian"
    cov = COVS.get(kind, 0.09)
    key = jax.random.PRNGKey(5)
    ref = case.run_jax(j_gauss.GaussianMove(cov, mode=mode, periodic=jnp.asarray(case.periods)),
                       key)
    move = GaussianMove(cov, mode=mode, periodic=torch.from_numpy(case.periods))
    got = case.run_port(move, _gaussian_draws(key, mode, case.ndim))
    case.check(got, ref, exact_coords=kind in ("scalar", "DE"))


def test_distribution_generate_on_jax_draws():
    # identical coords (ppf draws), accept counts and log priors
    case = Case()
    key = jax.random.PRNGKey(6)
    ref = case.run_jax(j_distgen.DistributionGenerate(case.pj), key)
    got = case.run_port(DistributionGenerate(case.pt), _distgen_draws(key, case.ndim))
    # the draws come from the prior: none is cut
    case.check(got, ref, cut=False)
    # a dict of coordinates takes the tree contract: one branch of one
    # active leaf, identical coords on the JAX tree move's draws
    def tree_fns(logp, logl):
        return (lambda c, i: logp(c["m"][..., 0, :]), lambda c, i: logl(c["m"][..., 0, :]))

    cj, ij = {"m": jnp.asarray(case.coords)[:, :, None]}, {"m": jnp.ones((NTEMPS, NWALKERS, 1), bool)}
    ref = j_distgen.DistributionGenerate(case.pj).propose(
        key, cj, ij, jnp.asarray(case.ll), jnp.asarray(case.lp), jnp.asarray(BETAS),
        *tree_fns(case.pj.logpdf, _ll_j))
    key, k_u = jax.random.split(key)
    key, k_draw = jax.random.split(key)
    draws = ({"m": _t(jax.random.uniform(k_draw, (NTEMPS, NWALKERS, 1, case.ndim)))},
             _t(jax.random.uniform(k_u, (NTEMPS, NWALKERS))))
    got = DistributionGenerate(case.pt).step_tree(
        {"m": torch.from_numpy(case.coords)[:, :, None]}, {"m": torch.ones((NTEMPS, NWALKERS, 1),
                                                                              dtype=torch.bool)},
        _t(case.ll), _t(case.lp), _t(BETAS), draws, *tree_fns(case.pt.logpdf, case.logl_t))
    np.testing.assert_array_equal(got[0]["m"].numpy(), np.asarray(ref[0]["m"]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("friends", [False, True])
def test_group_stretch_on_jax_draws(friends):
    # identical coords with and without a friends snapshot
    case = Case()
    key = jax.random.PRNGKey(7)
    per_j, per_t = jnp.asarray(case.periods), torch.from_numpy(case.periods)
    fr = np.random.default_rng(4).normal(_means(case.ndim), 0.5, (16, case.ndim))
    move_j = j_group.GroupStretchMove(a=2.0, periodic=per_j)
    move_t = GroupStretchMove(a=2.0, periodic=per_t)
    if friends:
        move_j.set_friends(fr)
        move_t.set_friends(fr)
        draws = _group_draws(key, 2.0, 16)
    else:
        draws = _stretch_draws(key, 2.0, NWALKERS // 2)
    case.check(case.run_port(move_t, draws), case.run_jax(move_j, key, compiled=True))


def test_delayed_rejection_on_jax_draws():
    # identical coords; stage 2 counts only where stage 1 rejected
    case = Case()
    key = jax.random.PRNGKey(9)
    sigma = np.array([0.4, 1.5, 0.3])
    ref = case.run_jax(j_group.DelayedRejectionMove(sigma, scale_2=0.2,
                                                     periodic=jnp.asarray(case.periods)), key)
    move = DelayedRejectionMove(sigma, scale_2=0.2, periodic=torch.from_numpy(case.periods))
    got = case.run_port(move, _dr_draws(key, case.ndim))
    case.check(got, ref)
    assert len(case.calls) == 2


def test_combine_move_on_jax_draws():
    # each sub-move on the key CombineMove splits for it; coords within
    # 1e-12 relative (the full-covariance Gaussian enters)
    case = Case()
    key = jax.random.PRNGKey(10)
    per_j, per_t = jnp.asarray(case.periods), torch.from_numpy(case.periods)
    ref = case.run_jax(j_group.CombineMove([
        j_gauss.GaussianMove(COVS["full"], periodic=per_j),
        j_gauss.GaussianMove(0.05, mode="DE", periodic=per_j),
        j_distgen.DistributionGenerate(case.pj)]), key)
    draws = []
    for replay in (lambda k: _gaussian_draws(k, "Gaussian", case.ndim),
                   lambda k: _gaussian_draws(k, "DE", case.ndim),
                   lambda k: _distgen_draws(k, case.ndim)):
        key, k = jax.random.split(key)
        draws.append(replay(k))
    move = CombineMove([GaussianMove(COVS["full"], periodic=per_t),
                        GaussianMove(0.05, mode="DE", periodic=per_t),
                        DistributionGenerate(case.pt)])
    case.check(case.run_port(move, draws), ref, exact_coords=False, moves=3)


def test_multiple_try_on_jax_draws():
    # identical coords; all candidates inside the prior go into one call
    case = Case()
    key = jax.random.PRNGKey(11)
    # candidates from a wider box than the prior, so some fall outside it
    qj = j_prior.ProbDistContainer({i: j_prior.uniform_dist(-0.5, 3.5) for i in range(3)})
    qt = t_prior.ProbDistContainer({i: t_prior.uniform_dist(-0.5, 3.5) for i in range(3)})
    ref = case.run_jax(j_mt.MTDistGenMove(qj, num_try=4), key)
    got = case.run_port(MTDistGenMove(qt, num_try=4), _mt_draws(key, case.ndim, 4))
    case.check(got, ref)
    assert len(case.calls) == 1


def test_dime_stateless_on_jax_draws():
    # coords within 1e-12 relative (the t branch's Cholesky factor)
    case = Case()
    key = jax.random.PRNGKey(12)
    ref = case.run_jax(j_stretch.DIMEMove(aimh_prob=0.4), key)
    got = case.run_port(DIMEMove(aimh_prob=0.4), _dime_draws(key, case.ndim, 10.0))
    case.check(got, ref, exact_coords=False)


@pytest.mark.parametrize("start", ["init", "no_weight"])
def test_dime_stateful_three_calls(start):
    # the carried state over 3 calls within 1e-12; "init" is the sampler's
    # start (cumlweight -inf, a finite first weight), "no_weight" the
    # -inf / -inf start (no walker accepted: the first weight is -inf too)
    case = Case()
    ndim, n = case.ndim, NTEMPS * NWALKERS
    move_j, move_t = j_stretch.DIMEMove(aimh_prob=0.5), DIMEMove(aimh_prob=0.5)
    st_j = move_j.init_move_state(NTEMPS, NWALKERS, ndim)
    st_t = move_t.init_move_state(NTEMPS, NWALKERS, ndim)
    if start == "no_weight":
        st_j = st_j._replace(naccepted=jnp.asarray(0, jnp.int32))
        st_t = st_t._replace(naccepted=torch.tensor(0))
    pj = case.pj

    def jstep(k, c, ll, lp, st):
        return move_j.propose_stateful(k, c, ll, lp, jnp.asarray(BETAS), pj.logpdf, _ll_j, st)

    c_j, ll_j, lp_j = (jnp.asarray(v) for v in (case.coords, case.ll, case.lp))
    c_t, ll_t, lp_t = (torch.from_numpy(v) for v in (case.coords, case.ll, case.lp))
    key = jax.random.PRNGKey(13)
    for it in range(3):
        key, k = jax.random.split(key)
        c_j, ll_j, lp_j, acc_j, st_j = jstep(k, c_j, ll_j, lp_j, st_j)
        c_t, ll_t, lp_t, acc_t, st_t = move_t.step_stateful(
            c_t, ll_t, lp_t, torch.from_numpy(BETAS), _dime_draws(k, ndim, 10.0), case.pt.logpdf,
            case.logl_t, st_t)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-12, atol=0)
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        np.testing.assert_allclose(st_t.mean.numpy(), np.asarray(st_j.mean), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(st_t.cov.numpy(), np.asarray(st_j.cov), rtol=1e-12, atol=1e-15)
        assert int(st_t.naccepted) == int(st_j.naccepted)
        if start == "no_weight" and it == 0:
            # both -inf: the new moments alone, the weight stays -inf
            assert float(st_t.cumlweight) == -np.inf == float(st_j.cumlweight)
            xc = case.coords.reshape(n, ndim)
            np.testing.assert_allclose(st_t.cov.numpy(), np.cov(xc.T), rtol=1e-12)
        else:
            np.testing.assert_allclose(float(st_t.cumlweight), float(st_j.cumlweight), rtol=1e-12)
            assert np.isfinite(float(st_t.cumlweight))


def test_sky_move_on_jax_draws():
    # identical coords; the reflection and the quarter turns
    # the sky columns' own boxes: cos iota, sin beta in [-1, 1], lam in
    # [0, 2 pi], psi in [0, pi]
    case = Case(ndim=4, periodic=False, boxes=[(-1, 1), (0, 2 * np.pi), (-1, 1), (0, np.pi)])
    case.periods[3] = np.pi
    imap = dict(cosinc=0, lam=1, sinbeta=2, psi=3)
    for which in ("both", "lat", "long"):
        key = jax.random.PRNGKey(14)
        case.calls.clear()
        ref = case.run_jax(j_gb.SkyMove(imap, which=which, periodic=jnp.asarray(case.periods)),
                           key)

        def proposal(k):
            k_flip, k_turn = jax.random.split(k)
            flip = (_t(jax.random.bernoulli(k_flip, 0.5, (NTEMPS, NWALKERS)))
                    if which == "both" else None)
            turn = (_t(jax.random.randint(k_turn, (NTEMPS, NWALKERS), 0, 4))
                    if which != "lat" else None)
            return flip, turn

        move = SkyMove(imap, which=which, periodic=torch.from_numpy(case.periods))
        got = case.run_port(move, _mh_draws(key, proposal))
        case.check(got, ref)


def test_multi_source_fisher_on_jax_draws():
    # coords within 1e-12 relative (the Cholesky blocks)
    case = Case(ndim=4, periodic=False)
    blocks = np.array([[[0.04, 0.015], [0.015, 0.02]], [[0.09, -0.02], [-0.02, 0.05]]])
    key = jax.random.PRNGKey(15)
    ref = case.run_jax(j_gb.MultiSourceFisherProposal(blocks, factor=1.3), key)
    draws = _mh_draws(key, lambda k: _t(jax.random.normal(k, (NTEMPS, NWALKERS, 2, 2))))
    got = case.run_port(MultiSourceFisherProposal(blocks, factor=1.3), draws)
    case.check(got, ref, exact_coords=False)


def test_pt_red_blue_on_jax_draws():
    # identical coords over 3 iterations, the ladder within 1e-14
    case = Case(ndim=2, periodic=False)
    betas0 = np.array([1.0, 0.3, 0.05])
    move_j = j_gb.PTRedBlueMove(betas0, NWALKERS, 2, adaptive=True, adaptation_lag=5,
                                adaptation_time=2)
    move_t = PTRedBlueMove(betas0, NWALKERS, 2, adaptive=True, adaptation_lag=5,
                           adaptation_time=2)

    def logp_j(x):
        return case.pj.logpdf(x)

    c_j, ll_j, lp_j = (jnp.asarray(v) for v in (case.coords, case.ll, case.lp))
    c_t, ll_t, lp_t = (torch.from_numpy(v) for v in (case.coords, case.ll, case.lp))
    key = jax.random.PRNGKey(16)
    for _ in range(3):
        key, k = jax.random.split(key)
        ref = move_j.propose(k, c_j, ll_j, lp_j, logp_j, _ll_j)
        c_j, ll_j, lp_j = ref[:3]
        _, k_move, k_swap = jax.random.split(k, 3)
        draws = (_stretch_draws(k_move, 2.0, NWALKERS // 2), _swap_draws(k_swap, NWALKERS, 3))
        got = move_t.step(c_t, ll_t, lp_t, draws, case.pt.logpdf, case.logl_t)
        c_t, ll_t, lp_t = got[:3]
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=0, atol=1e-14)
    assert move_t.time == move_j.time == 3
    np.testing.assert_allclose(move_t.swaps_accepted, move_j.swaps_accepted, rtol=0, atol=1e-14)
    assert abs(move_t.betas[1] - betas0[1]) > 1e-6


def test_chisquare_draws():
    # the Marsaglia-Tsang chi-square: mean df, variance 2 df (5 sigma)
    gen = torch.Generator().manual_seed(3)
    for df in (10.0, 3.5):
        x = chisquare(gen, df, 40000).numpy()
        assert (x > 0).all()
        assert abs(x.mean() - df) < 5 * math.sqrt(2 * df / x.size)
        assert abs(x.var() - 2 * df) < 0.05 * 2 * df


# ---- the sampler's move schedule ----

MEANS3 = np.array([1.0, -0.5, 2.0])


def _gauss_ll(x):
    return -0.5 * torch.sum((x - torch.from_numpy(MEANS3)) ** 2, dim=-1) / SIGMA**2


def _box(ndim, lo=-10.0, hi=10.0):
    return ProbDistContainer({i: uniform_dist(lo, hi) for i in range(ndim)})


def _start(ntemps, nwalkers, seed=2):
    return np.random.default_rng(seed).normal(MEANS3, SIGMA, (ntemps, nwalkers, 3))


def test_move_list_runs_a_schedule():
    # a plain list is an equal-weight schedule (the flat sampler refused
    # it before the schedule was ported); the first move is self.move
    moves = [StretchMove(), StretchMove(a=3.0)]
    sampler = EnsembleSampler(8, [3], _gauss_ll, {"model_0": _box(3)}, moves=moves, seed=4)
    assert sampler.moves == moves and sampler.move is moves[0]
    np.testing.assert_array_equal(sampler.move_weights, [0.5, 0.5])
    last = sampler.run_mcmc(_start(1, 8), 5)
    assert sampler.backend.iteration == 5 and last.move_info == (None, None)
    assert np.isfinite(sampler.get_log_like()).all()


def test_schedule_selection_and_move_info_threading():
    # on a given index sequence: each iteration runs the selected move only
    # (the others' draws are not taken), and a DIME slot's state changes
    # only when its move runs; the chain equals the moves applied by hand
    ntemps, nwalkers = 2, 8
    moves = [(DIMEMove(), 0.5), (GaussianMove(0.05), 0.3), (DIMEMove(aimh_prob=0.5), 0.2)]
    sampler = EnsembleSampler(nwalkers, [3], _gauss_ll, {"model_0": _box(3)}, moves=moves,
                              tempering_kwargs={"ntemps": ntemps}, seed=17)
    np.testing.assert_allclose(sampler.move_weights, [0.5, 0.3, 0.2], rtol=1e-15)
    order = iter([0, 1, 2, 2, 0])
    sampler._select_move = lambda generator: next(order)
    state = sampler._coerce_state(_start(ntemps, nwalkers))
    coords = state.branches["model_0"].coords[:, :, 0, :]
    ll, lp, betas, seed = state.log_like, state.log_prior, state.betas, state.random_state
    info = tuple(m.init_move_state(ntemps, nwalkers, 3) if isinstance(m, DIMEMove) else None
                 for m, _ in moves)
    for it, (got, j) in enumerate(zip(sampler.sample(state, 5), [0, 1, 2, 2, 0])):
        gen = torch.Generator().manual_seed(seed)
        move = sampler.moves[j]
        if info[j] is None:
            coords, ll, lp, _ = move.propose(gen, coords, ll, lp, betas, sampler._logp,
                                             sampler._logl)
        else:
            coords, ll, lp, _, ms = move.propose_stateful(gen, coords, ll, lp, betas,
                                                          sampler._logp, sampler._logl, info[j])
            info = info[:j] + (ms,) + info[j + 1:]
        tc = sampler.temperature_control
        coords, ll, lp, swap = tc.temperature_swaps(gen, coords, ll, lp, betas)
        betas = tc.adapt_ladder(betas, swap, float(it))
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        np.testing.assert_array_equal(got.branches["model_0"].coords[:, :, 0].numpy(),
                                      coords.numpy())
        np.testing.assert_array_equal(got.log_like.numpy(), ll.numpy())
        assert got.random_state == seed
        assert got.move_info[1] is None
        for k in (0, 2):
            for a, b in zip(got.move_info[k], info[k]):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    # each DIME slot ran twice and holds finite moments
    for k in (0, 2):
        st = got.move_info[k]
        assert isinstance(st, DIMEState) and np.isfinite(float(st.cumlweight))
        assert torch.isfinite(st.mean).all() and torch.isfinite(st.cov).all()


def test_select_move_draws_by_weight():
    # one uniform per iteration against the cumulative weights; a single
    # move takes no draw, so a one-move chain is unchanged by the schedule
    sampler = EnsembleSampler(8, [3], _gauss_ll, {"model_0": _box(3)},
                              moves=[(StretchMove(), 1.0), (GaussianMove(0.05), 3.0)])
    gen = torch.Generator().manual_seed(5)
    picks = np.array([sampler._select_move(gen) for _ in range(4000)])
    assert set(picks) == {0, 1}
    assert abs(picks.mean() - 0.75) < 3 * math.sqrt(0.75 * 0.25 / 4000)
    one = EnsembleSampler(8, [3], _gauss_ll, {"model_0": _box(3)})
    before = gen.get_state()
    assert one._select_move(gen) == 0 and torch.equal(gen.get_state(), before)


def test_sample_carries_dime_state_and_resumes():
    # State.move_info holds the DIME state after sampling, and a run resumed
    # from that state continues it (the same chain as one unbroken run)
    def run(splits):
        sampler = EnsembleSampler(16, [3], _gauss_ll, {"model_0": _box(3)}, moves=DIMEMove(),
                                  seed=21)
        state = make_state(torch.from_numpy(_start(1, 16)))
        for n in splits:
            state = sampler.run_mcmc(state, n)
        return state

    whole, parts = run([4]), run([2, 2])
    assert isinstance(whole.move_info[0], DIMEState)
    np.testing.assert_array_equal(whole.branches["model_0"].coords.numpy(),
                                  parts.branches["model_0"].coords.numpy())
    for a, b in zip(whole.move_info[0], parts.move_info[0]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- the reference's own sampling tests, at small size, on the port's draws ----

@pytest.mark.parametrize("mode", ["Gaussian", "AM", "DE"])
def test_gaussian_move_sampling(mode):
    # tests/test_inference.py::TestGaussianMoves
    sampler = EnsembleSampler(32, [3], _gauss_ll, {"model_0": _box(3)},
                              moves=GaussianMove(0.05, mode=mode), seed=4)
    sampler.run_mcmc(_start(1, 32), 300, burn=50)
    flat = sampler.get_chain(discard=100)["model_0"][:, 0, :, 0, :].reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(axis=0), MEANS3, atol=0.25)


def test_weighted_move_mixture():
    # tests/test_inference.py::TestMoveSchedule
    sampler = EnsembleSampler(32, [3], _gauss_ll, {"model_0": _box(3)},
                              moves=[(StretchMove(a=2.0), 0.7), (GaussianMove(0.05), 0.3)],
                              seed=9)
    sampler.run_mcmc(_start(1, 32, seed=3), 300, burn=50)
    flat = sampler.get_chain(discard=100)["model_0"][:, 0, :, 0, :].reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(axis=0), MEANS3, atol=0.2)


def _std_normal(x):
    return -0.5 * torch.sum(x**2, dim=-1)


def test_dime_samples_gaussian():
    # tests/test_inference.py::TestDIMEMove::test_dime_samples_gaussian
    priors = _box(3, -8, 8)
    ens = EnsembleSampler(48, 3, _std_normal, priors, moves=DIMEMove(), seed=9)
    coords = priors.rvs(size=(1, 48), random_state=1) * 0.3
    ens.run_mcmc(coords[:, :, None, :], 200, burn=50)
    samples = ens.get_chain(discard=50)["model_0"][:, 0].reshape(-1, 3)
    assert abs(samples.mean()) < 0.15
    assert abs(samples.std() - 1.0) < 0.15
    assert ens.acceptance_fraction.mean() > 0.2


def test_dime_multimodal_mixing():
    # tests/test_inference.py::TestDIMEMove::test_dime_multimodal_mixing:
    # an imbalanced start (52 walkers at +mu, 12 at -mu) is rebalanced by
    # the global t proposals, and walkers cross between the modes
    mu = 4.0

    def log_like(x):
        a = -0.5 * torch.sum((x - mu) ** 2, dim=-1) / 0.25
        b = -0.5 * torch.sum((x + mu) ** 2, dim=-1) / 0.25
        return torch.logaddexp(a, b)

    ens = EnsembleSampler(64, 2, log_like, _box(2), moves=DIMEMove(aimh_prob=0.3), seed=11)
    rng = np.random.default_rng(3)
    coords = mu + 0.5 * rng.standard_normal((1, 64, 2))
    coords[0, :12] = -coords[0, :12]
    ens.run_mcmc(coords[:, :, None, :], 400, burn=100)
    labels = ens.get_chain(discard=100)["model_0"][:, 0][..., 0, 0] > 0
    assert 0.25 < float(labels.mean()) < 0.75
    assert np.sum(labels[1:] != labels[:-1]) > 10


def test_mt_gaussian_posterior():
    # tests/test_eryn_rj.py::TestMT
    priors = _box(3, -5, 5)
    ens = EnsembleSampler(20, 3, _std_normal, priors, moves=MTDistGenMove(priors, num_try=10),
                          tempering_kwargs={"ntemps": 4}, seed=2)
    ens.run_mcmc(priors.rvs(size=(4, 20), random_state=4)[:, :, None, :], 50, burn=15)
    samples = ens.get_chain()["model_0"][:, 0].reshape(-1, 3)
    assert abs(samples.mean()) < 0.25
    assert abs(samples.std() - 1.0) < 0.2
    assert ens.acceptance_fraction.mean() > 0.01


def test_distgen_flat_gaussian_posterior():
    # tests/test_eryn_rj.py::TestDistGen::test_flat_gaussian_posterior
    priors = _box(2, -5, 5)
    ens = EnsembleSampler(24, 2, _std_normal, priors, moves=DistributionGenerate(priors),
                          tempering_kwargs={"ntemps": 2}, seed=6)
    ens.run_mcmc(priors.rvs(size=(2, 24), random_state=5)[:, :, None, :], 120, burn=20)
    samples = ens.get_chain()["model_0"][:, 0].reshape(-1, 2)
    assert abs(samples.mean()) < 0.2
    assert abs(samples.std() - 1.0) < 0.2
    assert ens.acceptance_fraction.mean() > 0.01


def test_group_stretch_samples_gaussian():
    # tests/test_eryn_rj.py::TestGroupAndDR::test_group_stretch_samples_gaussian
    priors = _box(2, -6, 6)
    move = GroupStretchMove()
    move.set_friends(np.random.default_rng(5).standard_normal((64, 2)))
    ens = EnsembleSampler(32, 2, _std_normal, priors, moves=move, seed=7)
    ens.run_mcmc(priors.rvs(size=(1, 32), random_state=6)[:, :, None, :], 150, burn=30)
    samples = ens.get_chain()["model_0"][:, 0].reshape(-1, 2)
    assert abs(samples.mean()) < 0.2
    assert abs(samples.std() - 1.0) < 0.2


def test_delayed_rejection_improves_acceptance():
    # tests/test_eryn_rj.py::TestGroupAndDR::test_delayed_rejection_improves_acceptance
    priors = _box(2, -6, 6)
    coords = priors.rvs(size=(1, 32), random_state=7)

    def run(move):
        ens = EnsembleSampler(32, 2, _std_normal, priors, moves=move, seed=11)
        ens.run_mcmc(coords[:, :, None, :], 120, burn=10)
        return ens.acceptance_fraction.mean(), ens.get_chain()["model_0"][:, 0].reshape(-1, 2)

    acc_dr, samples = run(DelayedRejectionMove(sigma=4.0, scale_2=0.1))
    acc_plain, _ = run(GaussianMove(16.0))
    assert acc_dr > acc_plain
    assert abs(samples.std() - 1.0) < 0.25


def test_combine_move():
    # tests/test_eryn_rj.py::TestGroupAndDR::test_combine_move
    priors = _box(2, -6, 6)
    ens = EnsembleSampler(16, 2, _std_normal, priors,
                          moves=CombineMove([GaussianMove(0.25), GaussianMove(0.01)]))
    last = ens.run_mcmc(priors.rvs(size=(1, 16), random_state=8)[:, :, None, :], 20)
    assert torch.isfinite(last.log_like).all()


def test_sky_lat_is_involution():
    # tests/test_gb_moves.py::TestSkyMove::test_lat_is_involution
    move = SkyMove(which="lat")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 8, 11)))
    draws = move.proposal_draws(torch.Generator().manual_seed(0), x.shape)
    once, f1 = move.get_proposal(x, draws)
    twice, _ = move.get_proposal(once, draws)
    np.testing.assert_allclose(twice.numpy(), x.numpy(), atol=1e-13)
    assert (f1 == 0).all()


def test_sky_long_stays_in_range():
    # tests/test_gb_moves.py::TestSkyMove::test_long_stays_in_range
    move = SkyMove(which="long")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 64, 11)))
    prop, _ = move.get_proposal(x, move.proposal_draws(torch.Generator().manual_seed(1), x.shape))
    assert ((prop[..., 9] >= 0) & (prop[..., 9] < np.pi)).all()
    assert ((prop[..., 7] >= 0) & (prop[..., 7] < 2 * np.pi)).all()


def test_sky_mode_hopping_explores_reflected_mode():
    # tests/test_gb_moves.py::TestSkyMove::test_mode_hopping_explores_reflected_mode
    def logl(x):
        return -0.5 * ((x[:, 8].abs() - 0.5) ** 2 + (x[:, 6].abs() - 0.5) ** 2) / 0.01

    def logp(x):
        ok = (x[:, 8].abs() < 1.0) & (x[:, 6].abs() < 1.0)
        return torch.where(ok, 0.0, -torch.inf).to(torch.float64)

    move = SkyMove(which="both")
    coords = torch.from_numpy(np.random.default_rng(2).uniform(0.45, 0.55, (1, 32, 11)))
    ll, lp = logl(coords[0])[None], logp(coords[0])[None]
    gen = torch.Generator().manual_seed(3)
    signs = []
    for _ in range(20):
        coords, ll, lp, _ = move.propose(gen, coords, ll, lp, torch.ones(1, dtype=torch.float64),
                                         logp, logl)
        signs.append(np.sign(coords[0, :, 8].numpy()))
    signs = np.concatenate(signs)
    assert (signs > 0).mean() > 0.2 and (signs < 0).mean() > 0.2


def test_multi_source_fisher_block_cov_sampling():
    # tests/test_gb_moves.py::TestMultiSourceFisher
    blocks = np.array([[[0.04, 0.015], [0.015, 0.02]], [[0.09, -0.02], [-0.02, 0.05]]])
    prec = torch.from_numpy(np.linalg.inv(blocks))

    def logl(x):
        q0 = torch.einsum("wi,ij,wj->w", x[:, :2], prec[0], x[:, :2])
        q1 = torch.einsum("wi,ij,wj->w", x[:, 2:], prec[1], x[:, 2:])
        return -0.5 * (q0 + q1)

    def logp(x):
        return torch.zeros(x.shape[0], dtype=torch.float64)

    move = MultiSourceFisherProposal(blocks, factor=1.2)
    coords = torch.from_numpy(0.1 * np.random.default_rng(5).standard_normal((1, 64, 4)))
    ll, lp = logl(coords[0])[None], torch.zeros((1, 64), dtype=torch.float64)
    gen = torch.Generator().manual_seed(7)
    hist = []
    for _ in range(600):
        coords, ll, lp, _ = move.propose(gen, coords, ll, lp, torch.ones(1, dtype=torch.float64),
                                         logp, logl)
        hist.append(coords[0].numpy())
    emp = np.cov(np.concatenate(hist[200:]).T)
    np.testing.assert_allclose(np.diag(emp), [0.04, 0.02, 0.09, 0.05], rtol=0.25)
    assert abs(emp[0, 2]) < 0.02 and abs(emp[1, 3]) < 0.02


def test_pt_red_blue_samples_and_adapts():
    # tests/test_gb_moves.py::TestPTRedBlue, its sampling and adaptation test
    def logl(x):
        return -0.5 * torch.sum(x**2, dim=-1) / 0.3**2

    def logp(x):
        return torch.where((x.abs() < 5.0).all(dim=-1), 0.0, -torch.inf).to(torch.float64)

    betas0 = np.array([1.0, 0.3, 0.05])
    move = PTRedBlueMove(betas0, 16, 2, adaptive=True)
    coords = torch.from_numpy(0.3 * np.random.default_rng(23).standard_normal((3, 16, 2)))
    ll, lp = logl(coords.reshape(-1, 2)).reshape(3, 16), logp(coords.reshape(-1, 2)).reshape(3, 16)
    gen = torch.Generator().manual_seed(29)
    hist = []
    for _ in range(150):
        coords, ll, lp, _, _ = move.propose(gen, coords, ll, lp, logp, logl)
        hist.append(coords[0].numpy())
    np.testing.assert_allclose(np.concatenate(hist[50:]).std(axis=0), 0.3, rtol=0.2)
    assert abs(move.betas[1] - betas0[1]) > 1e-6 and move.betas[0] == 1.0 and move.time == 150


def test_pt_walker_guard():
    # tests/test_gb_moves.py::TestPTRedBlue::test_walker_guard
    with pytest.raises(RuntimeError):
        PTRedBlueMove(np.array([1.0]), nwalkers=4, ndim=8)
