"""The PyTorch port's tree and reversible-jump moves against the JAX package.

Each move is run by both packages on the same seeded state: two branches
("gauss", 3 leaves of 3 parameters; "sine", 2 leaves of 3 with a periodic
phase), leaf masks that leave some walkers only a birth, some only a death
and some both, inactive placeholders outside the prior, and a ladder with a
beta = 0 rung. The JAX move runs op by op from a PRNG key, as the
reference's own move tests run it; the draws it takes from that key are
rebuilt here by replaying its ``jax.random.split`` sequence and fed to the
port's move (``step(..., draws, ...)``), which evaluates the likelihood
through the sampler's own ``_tree_logp`` / ``_tree_logl``. Accept counts,
leaf masks and log priors must be identical, log L within 1e-12 relative,
coordinates identical where no Cholesky factor or matrix product enters the
update (stretch, RJ, distribution draws, the GB jump), else within 1e-12
relative (the full-covariance tree Gaussian). Moves whose tries fold into
the walker axis (the multiple-try RJ, the GB jump) run on one branch, as
the reference can only run them. Then one whole `_step_tree` iteration, the
port's own draw order, and small-size versions of the reference's own
multi-branch / RJ sampling tests on the port's draws.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import prior as j_prior
from emri_frequencydomainwaveforms_tpu.inference.ensemble import EnsembleSampler as JSampler
from emri_frequencydomainwaveforms_tpu.inference.moves import distgen as j_distgen
from emri_frequencydomainwaveforms_tpu.inference.moves import gaussian as j_gauss
from emri_frequencydomainwaveforms_tpu.inference.moves import gb as j_gb
from emri_frequencydomainwaveforms_tpu.inference.moves import mt as j_mt
from emri_frequencydomainwaveforms_tpu.inference.moves import rj as j_rj
from emri_frequencydomainwaveforms_tpu.inference.moves import stretch as j_stretch
from emri_frequencydomainwaveforms_tpu.inference.moves import tree as j_tree
from emri_frequencydomainwaveforms_tpu_torch.inference import prior as t_prior
from emri_frequencydomainwaveforms_tpu_torch.inference.backends.hdf import TempHDFBackend
from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import (
    BruteRejectionRJ,
    DelayedRejectionRJ,
    DistributionGenerate,
    DistributionGenerateRJ,
    GaussianMove,
    GBFreqJump,
    MTDistGenMoveRJ,
    SkyMove,
    StretchMove,
    TreeGaussianMove,
    TreeStretchMove,
)
from emri_frequencydomainwaveforms_tpu_torch.inference.moves.tempering import swap_cascade
from emri_frequencydomainwaveforms_tpu_torch.inference.state import make_state

NTEMPS, NWALKERS = 3, 8
BETAS = np.array([1.0, 0.4, 0.0])
T_GRID = np.linspace(-1.0, 1.0, 64)
NDIMS = {"gauss": 3, "sine": 3}
NLEAVES = {"gauss": 3, "sine": 2}
NMIN = {"gauss": 0, "sine": 0}
BOXES = {"gauss": [(2.5, 3.5), (-1.0, 1.0), (0.01, 0.21)],
         "sine": [(0.5, 1.5), (1.0, 5.0), (0.0, 2 * np.pi)]}
PERIODS = {"sine": np.array([0.0, 0.0, 2 * np.pi])}
INJ = {"gauss": [[3.3, -0.4, 0.1], [2.8, 0.3, 0.12]], "sine": [[1.0, 2.5, 1.0]]}
# inactive leaves' placeholders, outside every prior box
PLACEHOLDER = {"gauss": [9.0, 5.0, 0.5], "sine": [-3.0, 9.0, 7.0]}
# active leaves per walker (rotated by the temperature index): 0 allows
# only a birth, the maximum only a death
COUNTS = {"gauss": [0, 1, 2, 3, 1, 2, 3, 0], "sine": [1, 2, 0, 1, 2, 0, 1, 2]}
NOISE = 0.5


def _data():
    rng = np.random.default_rng(42)
    y = sum(a * np.exp(-((T_GRID - b) ** 2) / (2 * c**2)) for a, b, c in INJ["gauss"])
    y = y + sum(a * np.sin(2 * np.pi * f * T_GRID + p) for a, f, p in INJ["sine"])
    return y + NOISE * rng.standard_normal(len(T_GRID))


DATA = _data()


def _tmpl(xp, name, c, i):
    t = xp.asarray(T_GRID)
    if name == "gauss":
        w = xp.where(i, xp.abs(c[..., 2]) + 1e-12, 1.0)
        f = c[..., 0, None] * xp.exp(-((t - c[..., 1, None]) ** 2) / (2.0 * w[..., None] ** 2))
    else:
        f = c[..., 0, None] * xp.sin(2.0 * np.pi * c[..., 1, None] * t + c[..., 2, None])
    return xp.sum(xp.where(i[..., None], f, 0.0), axis=-2)


def _ll(xp, coords, inds):
    """log L of (T', W', L, d) trees, or of the "gauss" branch's bare
    arrays; ``xp`` is jnp or a torch namespace."""
    if not isinstance(coords, dict):
        coords, inds = {"gauss": coords}, {"gauss": inds}
    tmpl = 0.0
    for name in coords:
        tmpl = tmpl + _tmpl(xp, name, coords[name], inds[name])
    return -0.5 * xp.sum((tmpl - xp.asarray(DATA)) ** 2, axis=-1) / NOISE**2


class _TorchNP:
    """The jnp calls `_ll` makes, on torch tensors."""

    @staticmethod
    def asarray(x):
        return torch.as_tensor(x, dtype=torch.float64)

    where = staticmethod(torch.where)
    abs = staticmethod(torch.abs)
    exp = staticmethod(torch.exp)
    sin = staticmethod(torch.sin)

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)


def _prior(mod, name):
    return mod.ProbDistContainer({k: mod.uniform_dist(*b) for k, b in enumerate(BOXES[name])})


def _samplers(names=("gauss", "sine"), jax_kw=None):
    """The JAX and the port sampler over ``names`` (their _tree_logp /
    _tree_logl are the moves' log prior and log L); the port's counts the
    rows of its likelihood calls."""
    rows = []

    def ll_t(c, i):
        rows.append(next(iter(c.values())).shape[1] if isinstance(c, dict) else c.shape[1])
        return _ll(_TorchNP, c, i)

    def ll_j(c, i):
        return _ll(jnp, c, i)

    common = dict(tempering_kwargs={"ntemps": NTEMPS, "betas": BETAS}, branch_names=list(names),
                  nleaves_max={n: NLEAVES[n] for n in names},
                  nleaves_min={n: NMIN[n] for n in names})
    ndims = {n: NDIMS[n] for n in names}
    js = JSampler(NWALKERS, ndims, ll_j, {n: _prior(j_prior, n) for n in names}, **common,
                  **(jax_kw or {}))
    ts = EnsembleSampler(NWALKERS, ndims, ll_t, {n: _prior(t_prior, n) for n in names},
                         **common)
    ts.rows = rows
    return js, ts


class Case:
    """A seeded multi-branch state, its log prior and log L from the JAX
    sampler."""

    def __init__(self, names=("gauss", "sine"), seed=3, jax_kw=None):
        rng = np.random.default_rng(seed)
        self.names = names
        self.coords, self.inds = {}, {}
        for name in names:
            nl, d = NLEAVES[name], NDIMS[name]
            lo, hi = np.array(BOXES[name]).T
            c = rng.uniform(lo, hi, (NTEMPS, NWALKERS, nl, d))
            ind = np.zeros((NTEMPS, NWALKERS, nl), bool)
            for t in range(NTEMPS):
                for w in range(NWALKERS):
                    ind[t, w, rng.permutation(nl)[:COUNTS[name][(w + t) % NWALKERS]]] = True
            self.coords[name] = np.where(ind[..., None], c, np.array(PLACEHOLDER[name]))
            self.inds[name] = ind
        self.js, self.ts = _samplers(names, jax_kw)
        cj, ij = self.jtree()
        self.lp = np.array(self.js._tree_logp(cj, ij))
        self.ll = np.array(self.js._tree_logl(cj, ij))
        assert np.isfinite(self.lp).all()

    def jtree(self):
        return ({k: jnp.asarray(v) for k, v in self.coords.items()},
                {k: jnp.asarray(v) for k, v in self.inds.items()})

    def ttree(self):
        return ({k: torch.from_numpy(v.copy()) for k, v in self.coords.items()},
                {k: torch.from_numpy(v.copy()) for k, v in self.inds.items()})

    def run_jax(self, propose, key):
        cj, ij = self.jtree()
        out = propose(key, cj, ij, jnp.asarray(self.ll), jnp.asarray(self.lp),
                      jnp.asarray(BETAS), self.js._tree_logp, self.js._tree_logl)
        return out

    def run_port(self, step, draws):
        """The port's move on ``draws``; ``self.calls`` keeps the rows of
        each of its likelihood calls."""
        ct, it = self.ttree()
        self.ts.rows.clear()
        out = step(ct, it, torch.from_numpy(self.ll), torch.from_numpy(self.lp),
                   torch.from_numpy(BETAS), draws, self.ts._tree_logp, self.ts._tree_logl)
        self.calls = list(self.ts.rows)
        return out

    def check(self, got, ref, exact_coords=True, some_accept=True):
        for name in self.names:
            if exact_coords:
                np.testing.assert_array_equal(got[0][name].numpy(), np.asarray(ref[0][name]))
            else:
                np.testing.assert_allclose(got[0][name].numpy(), np.asarray(ref[0][name]),
                                           rtol=1e-12, atol=0)
            np.testing.assert_array_equal(got[1][name].numpy(), np.asarray(ref[1][name]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-12, atol=0)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        if some_accept:
            assert 0 < int(got[4].sum()) < NTEMPS * NWALKERS * len(self.names)
        # the bookkeeping: each stored log L is the fresh value of its walker
        fresh = self.ts._tree_logl(*got[:2]).numpy()
        np.testing.assert_allclose(got[2].numpy(), fresh, rtol=1e-12, atol=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


# ---- the JAX moves' draws, replayed from their keys ----

def _stretch_draws(key, a=2.0, gibbs=None):
    nh = NWALKERS // 2
    g = None
    if gibbs is not None:
        key, k_g = jax.random.split(key)
        g = int(jax.random.randint(k_g, (), 0, len(gibbs)))
    halves = []
    for _ in range(2):
        key, k_z, k_c, k_u = jax.random.split(key, 4)
        z = ((a - 1.0) * jax.random.uniform(k_z, (NTEMPS, nh)) + 1.0) ** 2 / a
        halves.append((_t(z), _t(jax.random.randint(k_c, (NTEMPS, nh), 0, nh)),
                       _u(k_u, (NTEMPS, nh))))
    return g, halves


def _gauss_draws(key, shapes, gibbs=None):
    key, k_u, k_g = jax.random.split(key, 3)
    g = int(jax.random.randint(k_g, (), 0, len(gibbs))) if gibbs is not None else None
    eps = {}
    for name, shape in shapes.items():
        key, k_n = jax.random.split(key)
        eps[name] = _t(jax.random.normal(k_n, shape))
    return g, eps, _u(k_u, (NTEMPS, NWALKERS))


def _distgen_draws(key, shapes):
    key, k_u = jax.random.split(key)
    u = {}
    for name, shape in shapes.items():
        key, k_draw = jax.random.split(key)
        u[name] = _u(k_draw, shape)
    return u, _u(k_u, (NTEMPS, NWALKERS))


def _rj_branch_draws(key, shape):
    t, w, nl, d = shape
    k_bd, k_slot, k_draw, k_u = jax.random.split(key, 4)
    return _u(k_bd, (t, w)), _u(k_slot, (t, w, nl)), _u(k_draw, (t, w, d)), _u(k_u, (t, w))


def _per_branch(key, shapes, branch_draws):
    out = []
    for shape in shapes.values():
        key, k_b = jax.random.split(key)
        out.append(branch_draws(k_b, shape))
    return out


def _dr_branch_draws(key, shape, max_iter):
    t, w, _, d = shape
    key, k0 = jax.random.split(key)
    first = _rj_branch_draws(k0, shape)
    stages = []
    for _ in range(max_iter):
        key, k_draw, k_u = jax.random.split(key, 3)
        stages.append((_u(k_draw, (t, w, d)), _u(k_u, (t, w))))
    return first, stages


def _mt_branch_draws(key, shape, j, cand=None):
    t, w, nl, d = shape
    k_bd, k_slot, k_draw, k_sel, k_u = jax.random.split(key, 5)
    cands = _u(k_draw, (t, w, j, d)) if cand is None else _t(cand(k_draw, (t, w, j, d))[0])
    return (_u(k_bd, (t, w)), _u(k_slot, (t, w, nl)), cands, _u(k_sel, (t, w, j)),
            _u(k_u, (t, w)))


def _swap_draws(key):
    hot, cold, u = [], [], []
    for _ in range(NTEMPS - 1):
        key, k1, k2, k_u = jax.random.split(key, 4)
        hot.append(_t(jax.random.permutation(k1, NWALKERS)))
        cold.append(_t(jax.random.permutation(k2, NWALKERS)))
        u.append(_u(k_u, (NWALKERS,)))
    return hot, cold, u


def _shapes(case):
    return {k: v.shape for k, v in case.coords.items()}


# ---- every tree and RJ move on JAX's draws ----

@pytest.mark.parametrize("gibbs", [None, [("gauss",), ("sine",)]])
def test_tree_stretch_on_jax_draws(gibbs):
    # identical coords, inds and accept counts; a walker with no dimension
    # moved is not evaluated
    case = Case()
    key = jax.random.PRNGKey(21)
    per_j = {k: jnp.asarray(v) for k, v in PERIODS.items()}
    ref = case.run_jax(j_tree.TreeStretchMove(periodic=per_j, gibbs_branches=gibbs).propose, key)
    move = TreeStretchMove(periodic=PERIODS, gibbs_branches=gibbs)
    got = case.run_port(move.step, _stretch_draws(key, gibbs=gibbs))
    case.check(got, ref)
    assert sum(case.calls) < NTEMPS * NWALKERS


@pytest.mark.parametrize("kind", ["diagonal", "full", "gibbs"])
def test_tree_gaussian_on_jax_draws(kind):
    # diagonal: identical coords; full: the Cholesky factor and the matrix
    # product, within 1e-12 relative
    case = Case()
    key = jax.random.PRNGKey(22)
    full = np.array([[0.01, 0.002, 0.0], [0.002, 0.02, -0.003], [0.0, -0.003, 0.005]])
    cov = ({"gauss": full, "sine": 2 * full} if kind == "full"
           else {"gauss": np.array([0.01, 0.02, 0.001]), "sine": 0.01})
    gibbs = [("gauss",), ("sine",)] if kind == "gibbs" else None
    per_j = {k: jnp.asarray(v) for k, v in PERIODS.items()}
    ref = case.run_jax(j_tree.TreeGaussianMove(cov, periodic=per_j, gibbs_branches=gibbs).propose,
                       key)
    move = TreeGaussianMove(cov, periodic=PERIODS, gibbs_branches=gibbs)
    got = case.run_port(move.step, _gauss_draws(key, _shapes(case), gibbs))
    case.check(got, ref, exact_coords=kind != "full")


def test_distribution_generate_tree_on_jax_draws():
    # identical coords: every active leaf redrawn, the summed q factors
    case = Case()
    key = jax.random.PRNGKey(23)
    qj = {n: _prior(j_prior, n) for n in case.names}
    qt = {n: _prior(t_prior, n) for n in case.names}
    ref = case.run_jax(j_distgen.DistributionGenerate(qj).propose, key)
    move = DistributionGenerate(qt)
    case.check(case.run_port(move.step_tree, _distgen_draws(key, _shapes(case))), ref)
    # `propose` dispatches a tree to the tree contract
    gen = torch.Generator().manual_seed(1)
    c, i = case.ttree()
    out = move.propose(gen, c, i, torch.from_numpy(case.ll), torch.from_numpy(case.lp),
                       torch.from_numpy(BETAS), case.ts._tree_logp, case.ts._tree_logl)
    assert set(out[0]) == set(case.names) and out[4].shape == (NTEMPS,)


def test_distribution_generate_rj_tree_on_jax_draws():
    # births and deaths in both branches, each branch accepted on its own
    case = Case()
    key = jax.random.PRNGKey(24)
    pj = {n: _prior(j_prior, n) for n in case.names}
    pt = {n: _prior(t_prior, n) for n in case.names}
    ref = case.run_jax(j_rj.DistributionGenerateRJ(pj, NMIN, NLEAVES).propose_tree, key)
    move = DistributionGenerateRJ(pt, NMIN, NLEAVES)
    got = case.run_port(move.step_tree, _per_branch(key, _shapes(case), _rj_branch_draws))
    case.check(got, ref)
    counts = {n: got[1][n].sum(-1) for n in case.names}
    for n in case.names:
        before = torch.from_numpy(case.inds[n].sum(-1))
        assert ((counts[n] - before).abs() <= 1).all()
        assert (counts[n] > before).any() and (counts[n] < before).any()


def test_distribution_generate_rj_bare_on_jax_draws():
    # the bare-array contract on one branch, the leaf prior from the move's own
    case = Case(names=("gauss",))
    key = jax.random.PRNGKey(25)
    prior_j, prior_t = _prior(j_prior, "gauss"), _prior(t_prior, "gauss")

    def ll_j(c, i):
        return _ll(jnp, c, i)

    def ll_t(c, i):
        return _ll(_TorchNP, c, i)

    cj, ij = case.jtree()
    ref = j_rj.DistributionGenerateRJ(prior_j, 0, 3).propose(
        key, cj["gauss"], ij["gauss"], jnp.asarray(case.ll), jnp.asarray(case.lp),
        jnp.asarray(BETAS), ll_j)
    ct, it = case.ttree()
    got = DistributionGenerateRJ(prior_t, 0, 3).step(
        ct["gauss"], it["gauss"], torch.from_numpy(case.ll), torch.from_numpy(case.lp),
        torch.from_numpy(BETAS), _rj_branch_draws(key, case.coords["gauss"].shape), ll_t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    assert 0 < int(got[4].sum()) < NTEMPS * NWALKERS


@pytest.mark.parametrize("names", [("gauss",), ("gauss", "sine")])
def test_delayed_rejection_rj_on_jax_draws(names):
    # identical coords; every stage draws, each evaluates only the walkers
    # still in delayed rejection
    case = Case(names=names)
    key = jax.random.PRNGKey(26)
    pj = {n: _prior(j_prior, n) for n in names}
    pt = {n: _prior(t_prior, n) for n in names}
    ref = case.run_jax(j_rj.DelayedRejectionRJ(pj, NMIN, NLEAVES, max_iter=3).propose_tree, key)
    move = DelayedRejectionRJ(pt, NMIN, NLEAVES, max_iter=3)
    draws = _per_branch(key, _shapes(case), lambda k, s: _dr_branch_draws(k, s, 3))
    case.check(case.run_port(move.step_tree, draws), ref)
    # 4 stages per branch at most, fewer walkers after stage 0
    assert len(case.calls) <= 4 * len(names)
    assert sum(case.calls) < 4 * len(names) * NTEMPS * NWALKERS


@pytest.mark.parametrize("greedy", [False, True])
def test_mt_rj_on_jax_draws(greedy):
    # identical coords; the reduced state and the candidate cloud, one call
    # each; the greedy (search-mode) selection of BruteRejectionRJ
    case = Case(names=("gauss",))
    key = jax.random.PRNGKey(27)
    qj, qt = {"gauss": _prior(j_prior, "gauss")}, {"gauss": _prior(t_prior, "gauss")}
    if greedy:
        move_j = j_gb.BruteRejectionRJ(qj, 3, take_max_ll=True, nleaves_min=NMIN,
                                       nleaves_max=NLEAVES)
        move_t = BruteRejectionRJ(qt, 3, take_max_ll=True, nleaves_min=NMIN, nleaves_max=NLEAVES)
    else:
        move_j = j_mt.MTDistGenMoveRJ(qj, num_try=3, nleaves_min=NMIN, nleaves_max=NLEAVES)
        move_t = MTDistGenMoveRJ(qt, num_try=3, nleaves_min=NMIN, nleaves_max=NLEAVES)
    ref = case.run_jax(move_j.propose_tree, key)
    draws = _per_branch(key, _shapes(case), lambda k, s: _mt_branch_draws(k, s, 3))
    case.check(case.run_port(move_t.step_tree, draws), ref)
    assert len(case.calls) == 2


def test_brute_rejection_point_generator_on_jax_draws():
    # candidates from a library (the JAX key's and the generator's own
    # draws of it); the parity run feeds the JAX candidates
    case = Case(names=("gauss",))
    lib = np.array([[3.3, -0.4, 0.1], [2.8, 0.3, 0.12], [3.0, 0.0, 0.05]])

    def from_library_j(key, shape):
        idx = jax.random.randint(key, shape[:-1], 0, len(lib))
        return jnp.asarray(lib)[idx], jnp.zeros(shape[:-1])

    def from_library_t(generator, shape):
        idx = torch.randint(0, len(lib), shape[:-1], generator=generator)
        return torch.from_numpy(lib)[idx], torch.zeros(shape[:-1])

    qj, qt = {"gauss": _prior(j_prior, "gauss")}, {"gauss": _prior(t_prior, "gauss")}
    move_j = j_gb.BruteRejectionRJ(qj, 4, point_generator_func=from_library_j,
                                   nleaves_min=NMIN, nleaves_max=NLEAVES)
    move_t = BruteRejectionRJ(qt, 4, point_generator_func=from_library_t, nleaves_min=NMIN,
                              nleaves_max=NLEAVES)
    key = jax.random.PRNGKey(28)
    ref = case.run_jax(move_j.propose_tree, key)
    draws = _per_branch(key, _shapes(case),
                        lambda k, s: _mt_branch_draws(k, s, 4, cand=from_library_j))
    case.check(case.run_port(move_t.step_tree, draws), ref)
    # tests/test_gb_moves.py::TestBruteRejectionRJ::test_point_generator_hook
    cand = move_t._draw(qt["gauss"], torch.Generator().manual_seed(0), (2, 4, 4, 3))
    assert cand.shape == (2, 4, 4, 3)
    d = np.linalg.norm(cand.numpy().reshape(-1, 1, 3) - lib[None], axis=-1).min(axis=1)
    assert d.max() < 1e-12


GB_NDIM = 8
GB_CENTER = np.array([1.0, 3.0, 0.2, 0.4, 0.3, 0.6, 0.7, -0.2])


def _gb_ll(xp, coords, inds):
    c = coords["gb"] if isinstance(coords, dict) else coords
    i = inds["gb"] if isinstance(inds, dict) else inds
    per_leaf = -0.5 * xp.sum((c - xp.asarray(GB_CENTER)) ** 2, axis=-1) / 0.05**2
    return xp.sum(xp.where(i, per_leaf, 0.0), axis=-1)


def _gb_draws(key, shape, j, n_redraw):
    t, w, nl, d = shape
    k_slot, k_cand, k_sel, k_u = jax.random.split(key, 4)
    k_rel, k_f0, k_pr = jax.random.split(k_cand, 3)
    return (_u(k_slot, (t, w, nl)), _t(jax.random.normal(k_rel, (t, w, j, d))),
            _t(jax.random.normal(k_f0, (t, w, j))), _u(k_pr, (t, w, j, n_redraw)),
            _u(k_sel, (t, w, j)), _u(k_u, (t, w)))


def test_gb_freq_jump_on_jax_draws():
    # identical coords: the relative and f0 steps, the prior redraw, the
    # cosine reflections; inds unchanged; walkers with no active leaf
    # neither evaluated nor accepted
    rng = np.random.default_rng(11)
    box = {k: (-5.0, 5.0) for k in range(GB_NDIM)}
    pj = j_prior.ProbDistContainer({k: j_prior.uniform_dist(*b) for k, b in box.items()})
    pt = t_prior.ProbDistContainer({k: t_prior.uniform_dist(*b) for k, b in box.items()})
    coords = GB_CENTER + 0.3 * rng.standard_normal((NTEMPS, NWALKERS, 2, GB_NDIM))
    coords[..., 4] = rng.uniform(-1.2, 1.2, coords.shape[:-1])
    inds = rng.uniform(size=(NTEMPS, NWALKERS, 2)) < 0.6
    inds[:, 0] = False
    coords = np.where(inds[..., None], coords, 9.0)
    rows = []

    def ll_t(c, i):
        rows.append(c.shape[1])
        return _gb_ll(_TorchNP, c, i)

    js = JSampler(NWALKERS, {"gb": GB_NDIM}, lambda c, i: _gb_ll(jnp, c, i), {"gb": pj},
                  tempering_kwargs={"ntemps": NTEMPS, "betas": BETAS}, branch_names=["gb"],
                  nleaves_max={"gb": 2})
    ts = EnsembleSampler(NWALKERS, {"gb": GB_NDIM}, ll_t, {"gb": pt},
                         tempering_kwargs={"ntemps": NTEMPS, "betas": BETAS},
                         branch_names=["gb"], nleaves_max={"gb": 2})
    lp = np.array(js._tree_logp({"gb": jnp.asarray(coords)}, {"gb": jnp.asarray(inds)}))
    ll = np.array(js._tree_logl({"gb": jnp.asarray(coords)}, {"gb": jnp.asarray(inds)}))
    kw = dict(num_try=4, prior_redraw=(2, 3), reflect_inds=(4, 7))
    key = jax.random.PRNGKey(29)
    ref = j_gb.GBFreqJump(1e-4, 0.02, priors=pj, **kw).propose(
        key, {"gb": jnp.asarray(coords)}, {"gb": jnp.asarray(inds)}, jnp.asarray(ll),
        jnp.asarray(lp), jnp.asarray(BETAS), js._tree_logp, js._tree_logl)

    move = GBFreqJump(1e-4, 0.02, priors=pt, **kw)
    got = move.step({"gb": torch.from_numpy(coords)}, {"gb": torch.from_numpy(inds)},
                    torch.from_numpy(ll), torch.from_numpy(lp), torch.from_numpy(BETAS),
                    _per_branch(key, {"gb": coords.shape}, lambda k, s: _gb_draws(k, s, 4, 2)),
                    ts._tree_logp,
                    ts._tree_logl)
    np.testing.assert_array_equal(got[0]["gb"].numpy(), np.asarray(ref[0]["gb"]))
    np.testing.assert_array_equal(got[1]["gb"].numpy(), inds)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    assert 0 < int(got[4].sum()) < NTEMPS * NWALKERS
    # one call, on the in-prior candidates of the walkers with an active leaf
    assert len(rows) == 1 and 0 < rows[0] <= int(inds.any(-1).sum()) * 4
    assert not got[0]["gb"][:, 0].ne(9.0).any()


def test_temperature_swaps_tree_on_jax_draws():
    # every tensor of the (coords, inds) tree swapped alike, the boolean
    # inds included; the flat cascade on the same draws agrees
    case = Case()
    key = jax.random.PRNGKey(30)
    tc_j = case.js.temperature_control
    cj, ij = case.jtree()
    tree_j, ll_j, lp_j, frac_j = tc_j.temperature_swaps_tree(
        key, (cj, ij), jnp.asarray(case.ll), jnp.asarray(case.lp), jnp.asarray(BETAS))
    draws = _swap_draws(key)
    tree_t, ll_t, lp_t, frac_t = swap_cascade(case.ttree(), torch.from_numpy(case.ll),
                                              torch.from_numpy(case.lp),
                                              torch.from_numpy(BETAS), *draws)
    for n in case.names:
        np.testing.assert_array_equal(tree_t[0][n].numpy(), np.asarray(tree_j[0][n]))
        np.testing.assert_array_equal(tree_t[1][n].numpy(), np.asarray(tree_j[1][n]))
        assert tree_t[1][n].dtype == torch.bool
    np.testing.assert_array_equal(ll_t.numpy(), np.asarray(ll_j))
    np.testing.assert_array_equal(lp_t.numpy(), np.asarray(lp_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))
    assert 0 < float(frac_t.sum()) < NTEMPS - 1
    flat = swap_cascade(torch.from_numpy(case.coords["gauss"]), torch.from_numpy(case.ll),
                        torch.from_numpy(case.lp), torch.from_numpy(BETAS), *draws)
    np.testing.assert_array_equal(flat[0].numpy(), tree_t[0]["gauss"].numpy())
    # the generator form draws as the flat cascade does
    tc = case.ts.temperature_control
    a = tc.temperature_swaps_tree(torch.Generator().manual_seed(4), case.ttree(),
                                  torch.from_numpy(case.ll), torch.from_numpy(case.lp),
                                  torch.from_numpy(BETAS))
    b = tc.temperature_swaps(torch.Generator().manual_seed(4),
                             torch.from_numpy(case.coords["sine"]), torch.from_numpy(case.ll),
                             torch.from_numpy(case.lp), torch.from_numpy(BETAS))
    np.testing.assert_array_equal(a[0][0]["sine"].numpy(), b[0].numpy())


@pytest.mark.parametrize("kind", ["cov_dict", "scalar", "diagonal", "full", "stretch", "other"])
def test_adapt_move(kind):
    # the lifted move's type and factors equal the reference's (the full
    # covariance's refactored Cholesky factor within 1e-12 relative)
    full = np.array([[0.04, 0.01, 0.0], [0.01, 0.05, 0.002], [0.0, 0.002, 0.03]])
    flat = {"cov_dict": ({"gauss": full, "sine": np.array([0.1, 0.2, 0.3])},) * 2,
            "scalar": (0.09,) * 2, "diagonal": (np.array([0.1, 0.2, 0.3]),) * 2,
            "full": (full,) * 2}
    js, ts = _samplers()
    if kind in flat:
        mj, mt = j_gauss.GaussianMove(*flat[kind][:1]), GaussianMove(*flat[kind][1:])
    elif kind == "stretch":
        mj, mt = j_stretch.StretchMove(a=3.0), StretchMove(a=3.0)
    else:
        with pytest.raises(ValueError, match="no multi-branch"):
            js._adapt_move(j_gb.SkyMove())
        with pytest.raises(ValueError, match="no multi-branch"):
            ts._adapt_move(SkyMove())
        return
    rj, rt = js._adapt_move(mj), ts._adapt_move(mt)
    assert type(rt).__name__ == type(rj).__name__
    if kind == "stretch":
        assert rt.a == rj.a == 3.0
        return
    for name in ("gauss", "sine"):
        kj, fj = rj._chol[name]
        kt, ft = rt._chol[name]
        assert kt == kj
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=1e-300)
    # tree moves and moves with a tree contract stay
    assert ts._adapt_move(rt) is rt
    dg = DistributionGenerate({"gauss": _prior(t_prior, "gauss")})
    assert ts._adapt_move(dg) is dg


def test_step_tree_on_jax_draws():
    # one whole iteration: the tree stretch, two RJ moves in turn, the swap
    # cascade over the tree and the ladder adaptation, each on the draws
    # the reference's _step_tree makes from its key
    pj = {n: _prior(j_prior, n) for n in NDIMS}
    pt = {n: _prior(t_prior, n) for n in NDIMS}
    kw_j = dict(rj_moves=[j_rj.DistributionGenerateRJ(pj, NMIN, NLEAVES),
                          j_rj.DelayedRejectionRJ(pj, NMIN, NLEAVES, max_iter=2)])
    case = Case(jax_kw=kw_j)
    ts = EnsembleSampler(NWALKERS, NDIMS, case.ts.log_like_fn, pt,
                         tempering_kwargs={"ntemps": NTEMPS, "betas": BETAS},
                         branch_names=list(NDIMS), nleaves_max=NLEAVES, nleaves_min=NMIN,
                         rj_moves=[DistributionGenerateRJ(pt, NMIN, NLEAVES),
                                   DelayedRejectionRJ(pt, NMIN, NLEAVES, max_iter=2)])
    assert type(case.js.move).__name__ == type(ts.move).__name__ == "TreeStretchMove"
    key = jax.random.PRNGKey(31)
    cj, ij = case.jtree()
    ref = case.js._step_tree(cj, ij, jnp.asarray(case.ll), jnp.asarray(case.lp),
                             jnp.asarray(BETAS), key, jnp.asarray(0.0))
    key, k_move, _ = jax.random.split(key, 3)
    key, k_rj1 = jax.random.split(key)
    key, k_rj2 = jax.random.split(key)
    key, k_swap = jax.random.split(key)
    shapes = _shapes(case)
    ts.move.draws = lambda gen, coords: _stretch_draws(k_move)
    ts.rj_moves[0].draws = lambda gen, coords: _per_branch(k_rj1, shapes, _rj_branch_draws)
    ts.rj_moves[1].draws = lambda gen, coords: _per_branch(
        k_rj2, shapes, lambda k, s: _dr_branch_draws(k, s, 2))
    ts.temperature_control.draws = lambda gen, nwalkers: _swap_draws(k_swap)
    ct, it = case.ttree()
    got = ts._step_tree(ct, it, torch.from_numpy(case.ll), torch.from_numpy(case.lp),
                        torch.from_numpy(BETAS), 5, 0)
    case.check((got[0], got[1], got[2], got[3], got[6]), (ref[0], ref[1], ref[2], ref[3], ref[6]))
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(ref[7]))
    assert int(got[7].sum()) > 0
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(got[8].numpy(), np.asarray(ref[8]))


def test_step_tree_draw_order():
    # the scheduled move's index (several moves), the move's draws, each RJ
    # move's, the swaps'; the last draw seeds the next iteration
    case = Case()
    pt = {n: _prior(t_prior, n) for n in NDIMS}
    moves = [(TreeStretchMove(), 0.5), (GaussianMove({"gauss": 1e-3, "sine": 1e-3}), 0.5)]
    rj = [DistributionGenerateRJ(pt, NMIN, NLEAVES)]
    ts = EnsembleSampler(NWALKERS, NDIMS, case.ts.log_like_fn, pt, moves=moves, rj_moves=rj,
                         tempering_kwargs={"ntemps": NTEMPS, "betas": BETAS},
                         branch_names=list(NDIMS), nleaves_max=NLEAVES, nleaves_min=NMIN)
    assert [type(m).__name__ for m in ts.moves] == ["TreeStretchMove", "TreeGaussianMove"]
    args = (torch.from_numpy(case.ll), torch.from_numpy(case.lp), torch.from_numpy(BETAS))
    got = ts._step_tree(*case.ttree(), *args, 77, 3)
    gen = torch.Generator().manual_seed(77)
    move = ts.moves[ts._select_move(gen)]
    out = move.propose(gen, *case.ttree(), *args, ts._tree_logp, ts._tree_logl)
    out = rj[0].propose_tree(gen, *out[:4], args[2], ts._tree_logp, ts._tree_logl)
    tree, ll, lp, frac = ts.temperature_control.temperature_swaps_tree(gen, out[:2], *out[2:4],
                                                                       args[2])
    betas = ts.temperature_control.adapt_ladder(args[2], frac, 3.0)
    seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    for n in NDIMS:
        np.testing.assert_array_equal(got[0][n].numpy(), tree[0][n].numpy())
        np.testing.assert_array_equal(got[1][n].numpy(), tree[1][n].numpy())
    np.testing.assert_array_equal(got[2].numpy(), ll.numpy())
    np.testing.assert_array_equal(got[4].numpy(), betas.numpy())
    assert got[5] == seed


def test_coerce_state_and_compute_log_like():
    # a start with log L 0 is evaluated in one call on the walkers inside
    # the prior; compute_log_like / compute_log_prior on dicts
    case = Case()
    coords = {k: v.copy() for k, v in case.coords.items()}
    coords["gauss"][0, 1, case.inds["gauss"][0, 1].argmax()] = 99.0  # outside the prior
    start = make_state(coords, inds=case.inds)
    case.ts.rows.clear()
    st = case.ts._coerce_state(start)
    assert case.ts.rows == [NTEMPS * NWALKERS - 1]
    assert st.log_like[0, 1] == -1e300 and st.log_prior[0, 1] == -np.inf
    lp = case.ts.compute_log_prior(coords, inds=case.inds)
    ll, blobs = case.ts.compute_log_like(coords, inds=case.inds, logp=lp)
    cj = {k: jnp.asarray(v) for k, v in coords.items()}
    ij = {k: jnp.asarray(v) for k, v in case.inds.items()}
    lp_j = case.js.compute_log_prior(cj, inds=ij)
    ll_j, _ = case.js.compute_log_like(cj, inds=ij, logp=lp_j)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lp_j))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(st.log_like.numpy(), ll.numpy())
    assert blobs is None


# ---- the reference's own multi-branch / RJ sampling tests, at small size ----

GAUSS_INJ = np.array([[3.3, -0.2, 0.1], [2.6, -0.1, 0.1], [3.4, 0.0, 0.1], [2.9, 0.3, 0.1]])
SINE_INJ = np.array([[1.3, 10.1, 1.0], [0.8, 4.6, 1.2]])
SIGMA = 2.0
RJ_GRID = torch.linspace(-1, 1, 256, dtype=torch.float64)
GAUSS_PRIOR = {0: (2.5, 3.5), 1: (-1.0, 1.0), 2: (0.01, 0.21)}
SINE_PRIOR = {0: (0.5, 1.5), 1: (1.0, 20.0), 2: (0.0, 2 * np.pi)}


def _box(spec):
    return t_prior.ProbDistContainer({k: t_prior.uniform_dist(*b) for k, b in spec.items()})


def _gauss_sum(c, i):
    w = torch.where(i, c[..., 2].abs() + 1e-12, 1.0)
    f = c[..., 0, None] * torch.exp(-((RJ_GRID - c[..., 1, None]) ** 2) / (2.0 * w[..., None] ** 2))
    return torch.sum(torch.where(i[..., None], f, 0.0), dim=-2)


def _sine_sum(c, i):
    f = c[..., 0, None] * torch.sin(2.0 * np.pi * c[..., 1, None] * RJ_GRID + c[..., 2, None])
    return torch.sum(torch.where(i[..., None], f, 0.0), dim=-2)


def _inject(include_sine=False, seed=42):
    rng = np.random.default_rng(seed)
    tg = RJ_GRID.numpy()
    y = np.zeros_like(tg)
    for a, b, c in GAUSS_INJ:
        y += a * np.exp(-((tg - b) ** 2) / (2 * c**2))
    if include_sine:
        for a, b, c in SINE_INJ:
            y += a * np.sin(2 * np.pi * b * tg + c)
    return torch.from_numpy(y + SIGMA * rng.standard_normal(len(tg)))


def _init_leaves(inj, nleaves_max, ntemps, nwalkers, rng):
    ndim = inj.shape[1]
    coords = np.zeros((ntemps, nwalkers, nleaves_max, ndim))
    inds = np.zeros((ntemps, nwalkers, nleaves_max), dtype=bool)
    for nn in range(min(len(inj), nleaves_max)):
        coords[:, :, nn] = inj[nn] + 1e-4 * rng.standard_normal((ntemps, nwalkers, ndim))
        inds[:, :, nn] = True
    coords[..., ~inds[0, 0], :] = inj[0]
    return coords, inds


def _gauss_like(coords, inds, data, sigma):
    return -0.5 * torch.sum(((_gauss_sum(coords, inds) - data) / sigma) ** 2, dim=-1)


def _two_branch_like(coords, inds, data, sigma):
    tmpl = _gauss_sum(coords["gauss"], inds["gauss"]) + _sine_sum(coords["sine"], inds["sine"])
    return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2, dim=-1)


def test_rj_single_branch():
    # tests/test_eryn_rj.py::TestRJ::test_rj_single_branch
    ntemps, nwalkers, ndim = 2, 16, 3
    rng = np.random.default_rng(0)
    ens = EnsembleSampler(
        nwalkers, {"gauss": ndim}, _gauss_like, {"gauss": _box(GAUSS_PRIOR)}, args=[_inject(), SIGMA],
        tempering_kwargs=dict(ntemps=ntemps), branch_names=["gauss"],
        nleaves_max={"gauss": 8}, nleaves_min={"gauss": 0},
        moves=GaussianMove({"gauss": np.ones(ndim) * 1e-5}),
        rj_moves=[DistributionGenerateRJ({"gauss": _box(GAUSS_PRIOR)}, nleaves_min={"gauss": 0},
                                         nleaves_max={"gauss": 8})])
    assert ens.multibranch and type(ens.move).__name__ == "TreeGaussianMove"
    coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
    lp = ens.compute_log_prior({"gauss": coords}, inds={"gauss": inds})
    ll, _ = ens.compute_log_like({"gauss": coords}, inds={"gauss": inds}, logp=lp)
    assert torch.isfinite(lp).all() and torch.isfinite(ll).all()
    last = ens.run_mcmc(make_state({"gauss": coords}, inds={"gauss": inds}), 15, burn=5)
    nleaves = ens.get_nleaves()["gauss"]
    assert nleaves.shape == (15, ntemps, nwalkers)
    assert nleaves.min() >= 0 and nleaves.max() <= 8
    assert 0 <= int(last.branches["gauss"].nleaves.min()) <= int(last.branches["gauss"].nleaves.max()) <= 8
    samples = ens.get_chain()["gauss"][:, 0].reshape(-1, ndim)
    assert (~np.isnan(samples[:, 0])).any()
    assert 2.0 < nleaves[:, 0].mean() <= 8.0
    assert ens.backend.rj_acceptance_fraction.shape == (ntemps, nwalkers)


def test_rj_multiple_branches_hdf():
    # tests/test_eryn_rj.py::TestRJ::test_rj_multiple_branches_hdf
    ntemps, nwalkers = 2, 12
    rng = np.random.default_rng(1)
    with TempHDFBackend() as backend:
        ens = EnsembleSampler(
            nwalkers, {"gauss": 3, "sine": 3}, _two_branch_like,
            {"gauss": _box(GAUSS_PRIOR), "sine": _box(SINE_PRIOR)}, args=[_inject(include_sine=True), SIGMA],
            tempering_kwargs=dict(ntemps=ntemps), branch_names=["gauss", "sine"],
            nleaves_max={"gauss": 8, "sine": 4}, nleaves_min={"gauss": 0, "sine": 0},
            moves=GaussianMove({"gauss": np.ones(3) * 1e-5, "sine": np.ones(3) * 1e-5}),
            rj_moves=True, backend=backend)
        cg, ig = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        cs, is_ = _init_leaves(SINE_INJ, 4, ntemps, nwalkers, rng)
        last = ens.run_mcmc(make_state({"gauss": cg, "sine": cs}, inds={"gauss": ig, "sine": is_}),
                            10, burn=3)
        assert ens.get_nleaves()["gauss"].shape == (10, ntemps, nwalkers)
        assert ens.get_nleaves()["sine"].max() <= 4
        chains = ens.get_chain()
        assert chains["gauss"].shape == (10, ntemps, nwalkers, 8, 3)
        assert chains["sine"].shape == (10, ntemps, nwalkers, 4, 3)
        resumed = backend.get_last_sample()
        for name in ("gauss", "sine"):
            np.testing.assert_array_equal(resumed.branches[name].inds.numpy(),
                                          last.branches[name].inds.numpy())


def test_gibbs_branch_setup():
    # tests/test_eryn_rj.py::TestRJ::test_gibbs_branch_setup: the sine branch
    # pinned (nleaves_min == nleaves_max), only the gauss count changes
    ntemps, nwalkers = 2, 12
    rng = np.random.default_rng(3)
    moves = TreeGaussianMove({"gauss": np.ones(3) * 1e-5, "sine": np.ones(3) * 1e-5},
                             gibbs_branches=[("gauss",), ("sine",)])
    ens = EnsembleSampler(
        nwalkers, {"gauss": 3, "sine": 3}, _two_branch_like,
        {"gauss": _box(GAUSS_PRIOR), "sine": _box(SINE_PRIOR)}, args=[_inject(include_sine=True), SIGMA],
        tempering_kwargs=dict(ntemps=ntemps), branch_names=["gauss", "sine"],
        nleaves_max={"gauss": 8, "sine": 2}, nleaves_min={"gauss": 0, "sine": 2},
        moves=moves, rj_moves=True)
    cg, ig = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
    cs, is_ = _init_leaves(SINE_INJ, 2, ntemps, nwalkers, rng)
    ens.run_mcmc(make_state({"gauss": cg, "sine": cs}, inds={"gauss": ig, "sine": is_}), 8, burn=2)
    assert (ens.get_nleaves()["sine"] == 2).all()


def test_distgen_tree_contract_runs():
    # tests/test_eryn_rj.py::TestDistGen::test_tree_contract_runs
    ntemps, nwalkers, ndim = 1, 12, 3
    rng = np.random.default_rng(3)
    gen = {"gauss": _box(GAUSS_PRIOR)}
    ens = EnsembleSampler(
        nwalkers, {"gauss": ndim}, _gauss_like, {"gauss": _box(GAUSS_PRIOR)}, args=[_inject(), SIGMA],
        branch_names=["gauss"], nleaves_max={"gauss": 6}, nleaves_min={"gauss": 0},
        moves=DistributionGenerate(gen),
        rj_moves=[DistributionGenerateRJ(gen, nleaves_min={"gauss": 0}, nleaves_max={"gauss": 6})])
    coords, inds = _init_leaves(GAUSS_INJ, 6, ntemps, nwalkers, rng)
    last = ens.run_mcmc(make_state({"gauss": coords}, inds={"gauss": inds}), 10, burn=2)
    assert torch.isfinite(last.log_like).all()
    nl = last.branches["gauss"].nleaves
    assert int(nl.min()) >= 0 and int(nl.max()) <= 6


def _mt_rj_sampler(rj, ntemps, nwalkers, seed=0):
    return EnsembleSampler(
        nwalkers, {"gauss": 3}, _gauss_like, {"gauss": _box(GAUSS_PRIOR)}, args=[_inject(), SIGMA],
        tempering_kwargs=dict(ntemps=ntemps), branch_names=["gauss"],
        nleaves_max={"gauss": 8}, nleaves_min={"gauss": 0},
        moves=GaussianMove({"gauss": np.ones(3) * 1e-5}), rj_moves=[rj], seed=seed)


def test_mt_rj_leaf_count_recovery():
    # tests/test_eryn_rj.py::TestMTRJ::test_mt_rj_leaf_count_recovery
    ntemps, nwalkers = 2, 16
    rng = np.random.default_rng(7)
    rj = MTDistGenMoveRJ({"gauss": _box(GAUSS_PRIOR)}, num_try=8, nleaves_min={"gauss": 0},
                         nleaves_max={"gauss": 8})
    ens = _mt_rj_sampler(rj, ntemps, nwalkers)
    coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
    last = ens.run_mcmc(make_state({"gauss": coords}, inds={"gauss": inds}), 15, burn=5)
    nleaves = ens.get_nleaves()["gauss"]
    assert nleaves.shape == (15, ntemps, nwalkers)
    assert nleaves.min() >= 0 and nleaves.max() <= 8
    assert 2.0 < nleaves[:, 0].mean() <= 8.0
    assert torch.isfinite(last.log_like).all()


def test_mt_rj_death_reduces_overfit():
    # tests/test_eryn_rj.py::TestMTRJ::test_mt_rj_death_reduces_overfit: all
    # 8 leaves active at the start; the spurious ones are pruned
    ntemps, nwalkers = 1, 16
    rng = np.random.default_rng(11)
    rj = MTDistGenMoveRJ({"gauss": _box(GAUSS_PRIOR)}, num_try=6, nleaves_min={"gauss": 0},
                         nleaves_max={"gauss": 8})
    ens = _mt_rj_sampler(rj, ntemps, nwalkers)
    coords = np.zeros((ntemps, nwalkers, 8, 3))
    for nn in range(8):
        coords[:, :, nn] = GAUSS_INJ[nn % 4] + np.array([0.0, 0.3 * (nn // 4), 0.0])
        coords[:, :, nn] += 1e-3 * rng.standard_normal((ntemps, nwalkers, 3))
    coords[..., 0] = np.clip(coords[..., 0], 2.51, 3.49)
    coords[..., 1] = np.clip(coords[..., 1], -0.99, 0.99)
    inds = np.ones((ntemps, nwalkers, 8), dtype=bool)
    ens.run_mcmc(make_state({"gauss": coords}, inds={"gauss": inds}), 20)
    assert ens.get_nleaves()["gauss"][-5:].mean() < 8.0


def test_dr_rj_improves_birth_acceptance():
    # tests/test_eryn_rj.py::TestDelayedRejectionRJ
    ntemps, nwalkers = 1, 16
    rng = np.random.default_rng(13)
    gen = {"gauss": _box(GAUSS_PRIOR)}

    def run(rj_move):
        ens = _mt_rj_sampler(rj_move, ntemps, nwalkers)
        coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        ens.run_mcmc(make_state({"gauss": coords}, inds={"gauss": inds}), 25)
        return ens.backend.rj_acceptance_fraction, ens.get_nleaves()["gauss"]

    acc_dr, nl_dr = run(DelayedRejectionRJ(gen, nleaves_min={"gauss": 0},
                                           nleaves_max={"gauss": 8}, max_iter=4))
    acc_plain, _ = run(DistributionGenerateRJ(gen, nleaves_min={"gauss": 0},
                                              nleaves_max={"gauss": 8}))
    assert nl_dr.min() >= 0 and nl_dr.max() <= 8
    assert np.sum(acc_dr) >= np.sum(acc_plain)


GB_PRIOR = {i: (-5.0, 5.0) for i in range(GB_NDIM)}


def _gb_tree_fns(prior):
    def logp(c, i):
        return torch.sum(torch.where(i["gb"], prior.logpdf(c["gb"]), 0.0), dim=-1)

    def logl(c, i):
        return _gb_ll(_TorchNP, c, i)

    return logp, logl


def test_gb_freq_jump_improves_likelihood():
    # tests/test_gb_moves.py::TestGBFreqJump::test_leaf_update_improves_likelihood,
    # on the draws of that test's own keys: its 120 prior redraws of two
    # columns 0.05 wide within [-5, 5] find the peak about twice, so the
    # test holds for its keys, not for every draw
    ntemps, nwalkers, nlmax = 1, 16, 2
    rng = np.random.default_rng(11)
    prior = _box(GB_PRIOR)
    move = GBFreqJump(df=1e-4, factor=0.02, num_try=8, priors=prior, prior_redraw=(2, 3),
                      reflect_inds=(4, 7))
    coords = torch.from_numpy(GB_CENTER + 0.3 * rng.standard_normal((ntemps, nwalkers, nlmax,
                                                                      GB_NDIM)))
    inds = torch.ones((ntemps, nwalkers, nlmax), dtype=torch.bool)
    inds[:, :, 1] = False
    logp, logl = _gb_tree_fns(prior)
    ll, lp = logl({"gb": coords}, {"gb": inds}), logp({"gb": coords}, {"gb": inds})
    key = jax.random.PRNGKey(13)
    ll0, n_acc = float(ll.mean()), 0
    for _ in range(15):
        key, k = jax.random.split(key)
        draws = _per_branch(k, {"gb": tuple(coords.shape)}, lambda kb, s: _gb_draws(kb, s, 8, 2))
        c, i, ll, lp, acc = move.step({"gb": coords}, {"gb": inds}, ll, lp,
                                      torch.ones(1, dtype=torch.float64), draws, logp, logl)
        coords, n_acc = c["gb"], n_acc + int(acc.sum())
        assert torch.equal(i["gb"], inds)
    assert float(ll.mean()) > ll0 and torch.isfinite(ll).all() and n_acc == 2


def test_gb_freq_jump_inactive_walkers_never_accept():
    # tests/test_gb_moves.py::TestGBFreqJump::test_inactive_walkers_never_accept
    prior = _box(GB_PRIOR)
    move = GBFreqJump(df=1e-4, factor=0.05, num_try=4, priors=prior, prior_redraw=(2, 3),
                      reflect_inds=())
    coords = torch.zeros((1, 8, 2, GB_NDIM), dtype=torch.float64)
    inds = torch.zeros((1, 8, 2), dtype=torch.bool)
    zeros = torch.zeros((1, 8), dtype=torch.float64)
    calls = []

    def fn(c, i):
        calls.append(1)
        return torch.zeros(c["gb"].shape[:2], dtype=torch.float64)

    out = move.propose_tree(torch.Generator().manual_seed(0), {"gb": coords}, {"gb": inds}, zeros,
                            zeros, torch.ones(1, dtype=torch.float64), fn, fn)
    assert int(out[4].sum()) == 0 and torch.equal(out[0]["gb"], coords)
    # the prior is evaluated, the likelihood not
    assert len(calls) == 1


@pytest.mark.parametrize("greedy", [False, True])
def test_brute_rejection_rj_sampling(greedy):
    # tests/test_gb_moves.py::TestBruteRejectionRJ: the leaf counts
    # (test_brute_rejection_rj_leaf_counts) and the search mode
    # (test_greedy_search_mode_runs)
    ntemps, nwalkers = 1, 16
    rng = np.random.default_rng(17)
    rj = BruteRejectionRJ({"gauss": _box(GAUSS_PRIOR)}, num_brute=6, take_max_ll=greedy,
                          nleaves_min={"gauss": 0}, nleaves_max={"gauss": 8})
    ens = _mt_rj_sampler(rj, ntemps, nwalkers)
    coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
    state = make_state({"gauss": coords}, inds={"gauss": inds})
    if greedy:
        assert torch.isfinite(ens.run_mcmc(state, 5).log_like).all()
        return
    last = ens.run_mcmc(state, 12, burn=3)
    nl = ens.get_nleaves()["gauss"]
    assert nl.min() >= 0 and nl.max() <= 8 and 2.0 < nl[:, 0].mean() <= 8.0
    assert torch.isfinite(last.log_like).all()


def test_rj_recovers_source_count():
    # tests/test_inference.py::TestReversibleJump::test_rj_recovers_source_count,
    # the bare-array RJ move with a Gaussian jitter step
    xgrid = torch.linspace(0, 10, 101, dtype=torch.float64)

    def pulse(c):
        return torch.exp(-0.5 * (xgrid - c[..., None]) ** 2 / 0.3**2)

    data = pulse(torch.tensor(3.0)) + pulse(torch.tensor(7.0))

    def logl_fn(coords, inds):
        model = torch.sum(torch.where(inds[..., None], pulse(coords[..., 0]), 0.0), dim=-2)
        return -0.5 * torch.sum((model - data) ** 2, dim=-1) / 0.05**2

    prior = t_prior.ProbDistContainer({0: t_prior.uniform_dist(0.0, 10.0)})
    rj = DistributionGenerateRJ(prior, nleaves_min=0, nleaves_max=4)
    rng = np.random.default_rng(0)
    coords = torch.from_numpy(rng.uniform(0, 10, (1, 24, 4, 1)))
    inds = torch.zeros((1, 24, 4), dtype=torch.bool)
    inds[..., 0] = True
    betas = torch.ones(1, dtype=torch.float64)
    ll, lp = logl_fn(coords, inds), torch.zeros((1, 24), dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    counts = []
    for i in range(400):
        coords, inds, ll, lp, _ = rj.propose(gen, coords, inds, ll, lp, betas, logl_fn)
        prop = torch.clamp(coords + 0.2 * torch.randn(coords.shape, generator=gen,
                                                      dtype=torch.float64), 0.0, 10.0)
        ll_prop = logl_fn(prop, inds)
        acc = torch.log(torch.rand(ll.shape, generator=gen, dtype=torch.float64)) < ll_prop - ll
        coords = torch.where(acc[..., None, None], prop, coords)
        ll = torch.where(acc, ll_prop, ll)
        if i > 200:
            counts.append(inds.sum(-1).numpy().ravel())
    assert 1.5 < np.mean(np.concatenate(counts)) < 2.8


def test_mt_rj_two_branches():
    # the JAX move cannot fold its tries into the walker axis with a second
    # branch (the branches' walker axes differ); the port repeats the other
    # branch's walkers, so each try sees its walker's whole tree: the
    # stored log L is each walker's fresh value, the leaf counts legal
    case = Case()
    qt = {n: _prior(t_prior, n) for n in case.names}
    move = MTDistGenMoveRJ(qt, num_try=3, nleaves_min=NMIN, nleaves_max=NLEAVES)
    got = case.run_port(move.step_tree, move.draws(torch.Generator().manual_seed(8),
                                                   case.ttree()[0]))
    assert len(case.calls) == 4 and 0 < int(got[4].sum())
    fresh = case.ts._tree_logl(*got[:2]).numpy()
    np.testing.assert_allclose(got[2].numpy(), fresh, rtol=1e-12, atol=0)
    for n in case.names:
        counts = got[1][n].sum(-1)
        assert int(counts.min()) >= NMIN[n] and int(counts.max()) <= NLEAVES[n]
