"""Tempered ensemble sampler, single- and multi-branch.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.ensemble
.EnsembleSampler``: construction, `compute_log_prior`, `compute_log_like`
(NaN -> -1e300, and -1e300 outside the prior), the move schedule (one move,
a list, or ``(move, weight)`` pairs), `sample`, `run_mcmc` with burn-in and
stopping / update hooks (`inference.stopping`), the getters and the
diagnostics `get_autocorr_time` and `walkers_independent`. Two
configurations share the driver:

* single branch, fixed dimension: coords (ntemps, nwalkers, ndim), the
  flat move contract (`moves.stretch.Move`), ``log_like_fn`` over (n, ndim)
  walkers; one iteration `_step` runs the scheduled move, the swap cascade
  and the ladder adaptation;
* multi-branch / reversible jump (``nleaves_max > 1``, several branches,
  or ``rj_moves``): coords and inds dicts per branch, the tree contract
  (`moves.tree`), ``log_like_fn(coords, inds, *args) -> (T', W')`` (bare
  arrays for one branch, dicts for several) with masked leaves; one
  iteration `_step_tree` runs the scheduled tree move, each RJ move in
  turn, the swap cascade over the tree and the ladder adaptation. Flat
  moves are lifted into tree moves (`_adapt_move`), and, as in the
  reference, ``periodic`` does not reach the tree moves.

The sampler's state lives on the CPU in float64; ``log_like_fn`` gets the
walkers there and may return its values from any device. Each iteration
draws from a ``torch.Generator`` seeded with the state's ``random_state``:
the scheduled move's index when there are several moves, then the move's
draws, then each RJ move's, then the swaps'; its last draw seeds the next
iteration, so a run is fixed by ``seed`` (and resumes exactly from a stored
state). A stateful flat move (`moves.stretch.DIMEMove`) carries its
adaptation state in ``State.move_info``, a tuple aligned with
``self.moves``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import tracing
from .backends.memory import Backend
from .moves.gaussian import GaussianMove
from .moves.rj import DistributionGenerateRJ
from .moves.stretch import StretchMove
from .moves.tempering import TemperatureControl
from .moves.tree import TreeGaussianMove, TreeStretchMove, tree_loglike
from .prior import ProbDistContainer
from .state import Branch, State, cpu64, make_state

_FILL = -1e300
_SEED_BOUND = 2**62


def _as_branch_dict(value, branch_names, default):
    if isinstance(value, dict):
        return {k: value.get(k, default) for k in branch_names}
    return {k: value for k in branch_names}


class EnsembleSampler:
    """Parallel-tempered ensemble MCMC (fixed dimension or reversible jump).

    Arguments as in the reference. ``moves``: one move (default
    `StretchMove`, or `TreeStretchMove` multi-branch), a list of moves
    (equal weights) or of ``(move, weight)`` pairs; ``rj_moves``: True (a
    prior-draw `DistributionGenerateRJ`), one RJ move or a list;
    ``tempering_kwargs``: `TemperatureControl` arguments with ``ntemps``;
    ``periodic``: {branch: {index: period}} or {index: period} (flat moves
    only); ``nleaves_max`` / ``nleaves_min``: ints or dicts per branch;
    ``backend``: a `Backend`, an `HDFBackend` or a file name; ``seed``: the
    first iteration's seed.
    """

    def __init__(
        self,
        nwalkers: int,
        ndims,
        log_like_fn: Callable,
        priors,
        *,
        tempering_kwargs=None,
        moves=None,
        rj_moves=None,
        args=None,
        kwargs=None,
        backend=None,
        vectorize: bool = True,
        periodic=None,
        update_fn=None,
        update_iterations: int = -1,
        stopping_fn=None,
        stopping_iterations: int = -1,
        branch_names=None,
        nbranches: int = 1,
        nleaves_max=1,
        nleaves_min=0,
        info=None,
        seed: int = 0,
        **extra,
    ):
        del vectorize, nbranches, extra
        self.nwalkers = nwalkers
        if isinstance(ndims, dict):
            branch_names = branch_names or list(ndims)
            self.ndims = {k: int(v) for k, v in ndims.items()}
        elif isinstance(ndims, (list, tuple, np.ndarray)):
            branch_names = branch_names or [f"model_{i}" for i in range(len(ndims))]
            self.ndims = {k: int(d) for k, d in zip(branch_names, ndims)}
        else:
            branch_names = branch_names or ["model_0"]
            self.ndims = {branch_names[0]: int(ndims)}
        self.branch_names = list(branch_names)
        self.branch_name = self.branch_names[0]
        self.ndim = self.ndims[self.branch_name]
        self.nleaves_max = _as_branch_dict(nleaves_max, self.branch_names, 1)
        self.nleaves_min = _as_branch_dict(nleaves_min, self.branch_names, 0)
        self.log_like_fn = log_like_fn
        self.args = tuple(args or ())
        self.kwargs = dict(kwargs or {})
        self.priors = self._parse_priors(priors)
        self._prior = self.priors[self.branch_name]

        if rj_moves is True:
            rj_moves = [DistributionGenerateRJ(self.priors, nleaves_min=self.nleaves_min,
                                               nleaves_max=self.nleaves_max)]
        elif rj_moves in (None, False):
            rj_moves = []
        elif not isinstance(rj_moves, (list, tuple)):
            rj_moves = [rj_moves]
        self.rj_moves = list(rj_moves)
        self.has_reversible_jump = bool(self.rj_moves)
        self.multibranch = (len(self.branch_names) > 1
                            or any(v > 1 for v in self.nleaves_max.values())
                            or self.has_reversible_jump)

        tempering_kwargs = dict(tempering_kwargs or {})
        ntemps = tempering_kwargs.pop("ntemps", 1)
        ndim_total = sum(self.ndims[k] * self.nleaves_max[k] for k in self.branch_names)
        self.temperature_control = TemperatureControl(ndim_total, nwalkers, ntemps=ntemps,
                                                      **tempering_kwargs)
        self.ntemps = self.temperature_control.ntemps

        per_vec = None
        if periodic is not None and not self.multibranch:
            per = periodic.get(self.branch_name, periodic) if isinstance(periodic, dict) else periodic
            per_vec = torch.zeros((self.ndim,), dtype=torch.float64)
            for idx, p in per.items():
                per_vec[int(idx)] = float(p)
        self.periodic_vec = per_vec

        if moves is None:
            moves = TreeStretchMove() if self.multibranch else StretchMove(periodic=per_vec)
        pairs = [m if isinstance(m, tuple) else (m, 1.0)
                 for m in (moves if isinstance(moves, (list, tuple)) else [moves])]
        self.moves = [self._adapt_move(m) for m, _ in pairs]
        w = np.array([float(wt) for _, wt in pairs])
        self.move_weights = w / w.sum()
        if not self.multibranch:
            for m in self.moves:
                if getattr(m, "periodic", None) is None:
                    m.periodic = per_vec
        # the first move is the one the stopping hooks adjust
        self.move = self.moves[0]

        if isinstance(backend, str):
            from .backends.hdf import HDFBackend

            backend = HDFBackend(backend)
        self.backend = backend if backend is not None else Backend()
        if not self.backend.initialized:
            self.backend.reset(nwalkers, self.ndims, ntemps=self.ntemps,
                               nleaves_max=self.nleaves_max, branch_names=self.branch_names)
        if info:
            self.backend.info.update(info)

        self.update_fn = update_fn
        self.update_iterations = update_iterations
        self.stopping_fn = stopping_fn
        self.stopping_iterations = stopping_iterations
        self.seed = int(seed)

    def _parse_priors(self, priors) -> dict:
        if isinstance(priors, ProbDistContainer):
            return {self.branch_name: priors}
        if isinstance(priors, dict):
            if all(isinstance(k, str) for k in priors):
                return {k: v if isinstance(v, ProbDistContainer) else ProbDistContainer(v)
                        for k, v in priors.items()}
            return {self.branch_name: ProbDistContainer(priors)}
        raise ValueError("priors must be a dict or ProbDistContainer")

    def _adapt_move(self, move):
        """A flat move lifted into its tree form when multi-branch: a
        `GaussianMove` (a covariance per branch, its Cholesky factor's
        covariance for every branch, or its scalar variance on every branch's
        diagonal) into `TreeGaussianMove`, a `StretchMove` into
        `TreeStretchMove`; tree moves stay; any other move raises."""
        if not self.multibranch:
            return move
        if hasattr(move, "propose_tree") or isinstance(move, (TreeStretchMove, TreeGaussianMove)):
            return move
        if isinstance(move, GaussianMove) and move.cov_dict is not None:
            return TreeGaussianMove(move.cov_dict)
        if isinstance(move, GaussianMove) and move._chol is not None:
            cov = (move._chol @ move._chol.T).numpy()
            return TreeGaussianMove({k: cov for k in self.branch_names})
        if isinstance(move, GaussianMove) and move._scale is not None:
            return TreeGaussianMove({k: (move._scale**2) * np.ones(self.ndims[k])
                                     for k in self.branch_names})
        if isinstance(move, StretchMove):
            return TreeStretchMove(a=move.a)
        raise ValueError(f"move {type(move).__name__} has no multi-branch (tree) form")

    # ---- model evaluation ----
    def _logp(self, x):
        return self._prior.logpdf(x)

    def _logl(self, x):
        return self.log_like_fn(x, *self.args, **self.kwargs)

    def _tree_logp(self, coords: dict, inds: dict) -> torch.Tensor:
        """The summed log prior of each walker's active leaves (a masked sum:
        inactive placeholders may lie outside the prior)."""
        lp = 0.0
        for name, c in coords.items():
            leaf_lp = self.priors[name].logpdf(c)
            lp = lp + torch.sum(torch.where(inds[name], leaf_lp, 0.0), dim=-1)
        return lp

    def _tree_logl(self, coords: dict, inds: dict) -> torch.Tensor:
        """``log_like_fn`` on a tree (bare arrays for one branch); NaN ->
        -1e300."""
        if len(self.branch_names) == 1:
            name = self.branch_names[0]
            ll = self.log_like_fn(coords[name], inds[name], *self.args, **self.kwargs)
        else:
            ll = self.log_like_fn(coords, inds, *self.args, **self.kwargs)
        ll = cpu64(ll)
        return torch.where(torch.isnan(ll), _FILL, ll)

    @staticmethod
    def _tree_of(coords, inds):
        coords = {k: cpu64(v) for k, v in coords.items()}
        if inds is None:
            return coords, {k: torch.ones(v.shape[:-1], dtype=torch.bool)
                            for k, v in coords.items()}
        return coords, {k: torch.as_tensor(v).to(torch.bool).cpu() for k, v in inds.items()}

    def compute_log_prior(self, coords, inds=None) -> torch.Tensor:
        if isinstance(coords, dict):
            return self._tree_logp(*self._tree_of(coords, inds))
        return self._prior.logpdf(cpu64(coords))

    def compute_log_like(self, coords, inds=None, logp=None):
        """log L of (..., ndim) walkers, or ``(log L, None)`` of a tree of
        (T, W, L, d) branches: NaN -> -1e300, and -1e300 where ``logp`` is
        not finite (those walkers are not evaluated)."""
        if isinstance(coords, dict):
            coords, inds = self._tree_of(coords, inds)
            shape = next(iter(coords.values())).shape[:2]
            need = (torch.ones(shape, dtype=torch.bool) if logp is None
                    else torch.isfinite(cpu64(logp)))
            return tree_loglike(self._tree_logl, coords, inds, need), None
        coords = cpu64(coords)
        flat = coords.reshape(-1, self.ndim)
        ll = torch.full((flat.shape[0],), _FILL, dtype=torch.float64)
        inside = (torch.ones_like(ll, dtype=torch.bool) if logp is None
                  else torch.isfinite(cpu64(logp)).reshape(-1))
        rows = torch.nonzero(inside)[:, 0]
        if rows.numel():
            ll[rows] = cpu64(self._logl(flat[rows])).reshape(-1)
        ll = torch.where(torch.isnan(ll), _FILL, ll)
        return ll.reshape(coords.shape[:-1])

    # ---- one iteration ----
    def _select_move(self, generator) -> int:
        """The index of this iteration's move, drawn with ``self.move_weights``
        from one uniform (no draw with a single move)."""
        if len(self.moves) == 1:
            return 0
        u = float(torch.rand((), generator=generator, dtype=torch.float64))
        return min(int(np.searchsorted(np.cumsum(self.move_weights), u, side="right")),
                   len(self.moves) - 1)

    def _step(self, coords, log_like, log_prior, betas, seed: int, iteration: int,
              move_info=None):
        """One iteration from ``seed``: returns (coords, log_like, log_prior,
        betas, next seed, accepted per temperature, swap acceptance,
        move_info)."""
        gen = torch.Generator().manual_seed(int(seed))
        j = self._select_move(gen)
        move = self.moves[j]
        if move_info is not None and move_info[j] is not None:
            coords, log_like, log_prior, n_acc, ms = move.propose_stateful(
                gen, coords, log_like, log_prior, betas, self._logp, self._logl, move_info[j])
            move_info = move_info[:j] + (ms,) + move_info[j + 1:]
        else:
            coords, log_like, log_prior, n_acc = move.propose(
                gen, coords, log_like, log_prior, betas, self._logp, self._logl)
        tc = self.temperature_control
        if self.ntemps > 1:
            coords, log_like, log_prior, swap_frac = tc.temperature_swaps(
                gen, coords, log_like, log_prior, betas)
            betas = tc.adapt_ladder(betas, swap_frac, float(iteration))
        else:
            swap_frac = torch.zeros((0,), dtype=torch.float64)
        next_seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=gen))
        return coords, log_like, log_prior, betas, next_seed, n_acc, swap_frac, move_info

    def _step_tree(self, coords, inds, log_like, log_prior, betas, seed: int, iteration: int):
        """One multi-branch iteration from ``seed``: returns (coords, inds,
        log_like, log_prior, betas, next seed, accepted per temperature, RJ
        accepted per temperature, swap acceptance)."""
        gen = torch.Generator().manual_seed(int(seed))
        move = self.moves[self._select_move(gen)]
        coords, inds, log_like, log_prior, n_acc = move.propose(
            gen, coords, inds, log_like, log_prior, betas, self._tree_logp, self._tree_logl)
        n_rj = torch.zeros_like(n_acc)
        for rj in self.rj_moves:
            coords, inds, log_like, log_prior, acc = rj.propose_tree(
                gen, coords, inds, log_like, log_prior, betas, self._tree_logp, self._tree_logl)
            n_rj = n_rj + acc
        tc = self.temperature_control
        if self.ntemps > 1:
            (coords, inds), log_like, log_prior, swap_frac = tc.temperature_swaps_tree(
                gen, (coords, inds), log_like, log_prior, betas)
            betas = tc.adapt_ladder(betas, swap_frac, float(iteration))
        else:
            swap_frac = torch.zeros((0,), dtype=torch.float64)
        next_seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=gen))
        return coords, inds, log_like, log_prior, betas, next_seed, n_acc, n_rj, swap_frac

    # ---- public API ----
    def run_mcmc(self, initial_state, nsteps: int, burn: int = 0, thin_by: int = 1,
                 progress: bool = False, **kwargs) -> State:
        state = self._coerce_state(initial_state)
        if burn:
            for state in self.sample(state, iterations=burn, thin_by=1, store=False):
                pass
        last = state
        for last in self.sample(state, iterations=nsteps, thin_by=thin_by, store=True):
            pass
        return last

    def sample(self, initial_state, iterations: int, thin_by: int = 1, store: bool = True,
               progress: bool = False):
        state = self._coerce_state(initial_state)
        if self.multibranch:
            yield from self._sample_tree(state, iterations, thin_by, store)
            return
        coords = state.branches[self.branch_name].coords[:, :, 0, :]
        log_like, log_prior, betas = state.log_like, state.log_prior, state.betas
        seed = state.random_state
        move_info = state.move_info
        if move_info is None:
            move_info = tuple(m.init_move_state(*coords.shape) if hasattr(m, "init_move_state")
                              else None for m in self.moves)
        it0 = self.backend.iteration * thin_by
        for i in range(iterations):
            with tracing.span("sampler.step"):
                for _ in range(thin_by):
                    (coords, log_like, log_prior, betas, seed, n_acc, swap_frac,
                     move_info) = self._step(coords, log_like, log_prior, betas, seed, it0 + i,
                                             move_info)
                state = State(
                    branches={self.branch_name: state.branches[self.branch_name]._replace(
                        coords=coords[:, :, None, :])},
                    log_like=log_like, log_prior=log_prior, betas=betas, random_state=seed,
                    move_info=move_info,
                )
                if store:
                    self.backend.save_step(state, n_acc, swap_frac=swap_frac)
                stop = self._run_hooks(i, state)
            yield state
            if stop:
                return

    def _sample_tree(self, state: State, iterations: int, thin_by: int, store: bool):
        coords = {k: b.coords for k, b in state.branches.items()}
        inds = {k: b.inds for k, b in state.branches.items()}
        log_like, log_prior, betas = state.log_like, state.log_prior, state.betas
        seed = state.random_state
        it0 = self.backend.iteration * thin_by
        for i in range(iterations):
            with tracing.span("sampler.step"):
                for _ in range(thin_by):
                    (coords, inds, log_like, log_prior, betas, seed, n_acc, n_rj,
                     swap_frac) = self._step_tree(coords, inds, log_like, log_prior, betas,
                                                  seed, it0 + i)
                state = State(branches={k: Branch(coords=coords[k], inds=inds[k])
                                        for k in coords},
                              log_like=log_like, log_prior=log_prior, betas=betas,
                              random_state=seed)
                if store:
                    self.backend.save_step(state, n_acc, rj_accepted=n_rj, swap_frac=swap_frac)
                stop = self._run_hooks(i, state)
            yield state
            if stop:
                return

    def _run_hooks(self, i, state) -> bool:
        if (self.stopping_fn is not None and self.stopping_iterations > 0
                and (i + 1) % self.stopping_iterations == 0):
            if self.stopping_fn(i, state, self):
                return True
        if (self.update_fn is not None and self.update_iterations > 0
                and (i + 1) % self.update_iterations == 0):
            self.update_fn(i, state, self)
        return False

    def _coerce_state(self, s) -> State:
        if isinstance(s, State):
            st = s
        elif isinstance(s, dict) and "coords" in s:
            st = make_state(**s, name=self.branch_name)
        elif isinstance(s, dict):
            st = make_state(s)
        else:
            st = make_state(s, name=self.branch_name)
        betas = st.betas
        if betas.shape[0] != self.ntemps or (self.ntemps > 1 and bool(torch.all(betas == 1.0))):
            # raw-array initial states carry placeholder unit betas
            betas = self.temperature_control.betas.clone()
        ll = st.log_like
        if self.multibranch:
            coords = {k: b.coords for k, b in st.branches.items()}
            inds = {k: b.inds for k, b in st.branches.items()}
            lp = self._tree_logp(coords, inds)
            if bool(torch.all(ll == 0)):
                # one call, on the walkers inside the prior
                ll = tree_loglike(self._tree_logl, coords, inds, torch.isfinite(lp))
        else:
            coords = st.branches[self.branch_name].coords[:, :, 0, :]
            lp = self.compute_log_prior(coords)
            if bool(torch.all(ll == 0)):
                ll = self.compute_log_like(coords, logp=lp)
        return State(
            branches=st.branches, log_like=ll, log_prior=lp, betas=betas,
            random_state=st.random_state if st.random_state is not None else self.seed,
            move_info=st.move_info,
        )

    # ---- accessors ----
    def get_chain(self, **kwargs):
        return self.backend.get_chain(**kwargs)

    def get_inds(self, **kwargs):
        return self.backend.get_inds(**kwargs)

    def get_nleaves(self, **kwargs):
        return self.backend.get_nleaves(**kwargs)

    def get_log_like(self, **kwargs):
        return self.backend.get_log_like(**kwargs)

    def get_autocorr_time(self, **kwargs):
        return self.backend.get_autocorr_time(**kwargs)

    @property
    def acceptance_fraction(self):
        return self.backend.acceptance_fraction

    def walkers_independent(self, coords=None) -> bool:
        """Whether the walkers span the parameter space: the condition number
        of the standardized, centred (nwalkers, ndim) positions (default the
        cold chain's last stored step) below 1e8."""
        if coords is None:
            last = self.backend.get_last_sample()
            coords = last.branches[self.branch_name].coords[0, :, 0, :]
        x = cpu64(coords).numpy()
        x = x - x.mean(axis=0)
        sigma = x.std(axis=0)
        sigma[sigma == 0] = 1.0
        return bool(np.linalg.cond(x / sigma) < 1e8)


__all__ = ["EnsembleSampler"]
