"""Tempered ensemble sampler, single branch, fixed dimension.

Counterpart of the single-branch path of
``emri_frequencydomainwaveforms_tpu.inference.ensemble.EnsembleSampler``:
construction, `compute_log_prior`, `compute_log_like` (NaN -> -1e300, and
-1e300 outside the prior), the move schedule (one move, a list, or
``(move, weight)`` pairs), one iteration `_step` (the scheduled move, the
temperature swap cascade, the ladder adaptation), `sample`, `run_mcmc` with
burn-in and stopping / update hooks (`inference.stopping`), the getters and
the diagnostics `get_autocorr_time` and `walkers_independent`. The
multi-branch and reversible-jump configurations (``nleaves_max > 1``,
several branches, ``rj_moves``, a `GaussianMove` with a covariance per
branch) are not ported.

The sampler's state lives on the CPU in float64; ``log_like_fn`` gets the
(n, ndim) walkers there and may return its (n,) values from any device.
Each iteration draws from a ``torch.Generator`` seeded with the state's
``random_state`` (the scheduled move's index when there are several moves,
then the move's draws, then the swaps'), and its last draw seeds the next
iteration, so a run is fixed by ``seed`` (and resumes exactly from a stored
state). A stateful move (`moves.stretch.DIMEMove`) carries its adaptation
state in ``State.move_info``, a tuple aligned with ``self.moves``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .backends.memory import Backend
from .moves.stretch import StretchMove
from .moves.tempering import TemperatureControl
from .prior import ProbDistContainer
from .state import State, cpu64, make_state

_FILL = -1e300
_SEED_BOUND = 2**62


class EnsembleSampler:
    """Parallel-tempered ensemble MCMC over one fixed-dimension branch.

    Arguments as in the reference. ``moves``: one move (default
    `StretchMove`), a list of moves (equal weights) or of ``(move, weight)``
    pairs; ``tempering_kwargs``: `TemperatureControl` arguments with
    ``ntemps``; ``periodic``: {branch: {index: period}} or {index: period};
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
        del vectorize, nbranches, nleaves_min, extra
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
        leaves = nleaves_max.values() if isinstance(nleaves_max, dict) else [nleaves_max]
        pairs = [m if isinstance(m, tuple) else (m, 1.0)
                 for m in (moves if isinstance(moves, (list, tuple)) else [moves])]
        per_branch_cov = any(getattr(m, "cov_dict", None) is not None for m, _ in pairs)
        if (len(self.branch_names) > 1 or any(int(v) > 1 for v in leaves) or rj_moves
                or per_branch_cov):
            raise NotImplementedError(
                "multi-branch / reversible-jump sampling is not ported: use the JAX package's "
                "inference.ensemble.EnsembleSampler (its _step_tree / _sample_tree path)"
            )
        self.branch_name = self.branch_names[0]
        self.ndim = self.ndims[self.branch_name]
        self.log_like_fn = log_like_fn
        self.args = tuple(args or ())
        self.kwargs = dict(kwargs or {})
        self._prior = self._parse_prior(priors)

        tempering_kwargs = dict(tempering_kwargs or {})
        ntemps = tempering_kwargs.pop("ntemps", 1)
        self.temperature_control = TemperatureControl(self.ndim, nwalkers, ntemps=ntemps,
                                                      **tempering_kwargs)
        self.ntemps = self.temperature_control.ntemps

        per_vec = None
        if periodic is not None:
            per = periodic.get(self.branch_name, periodic) if isinstance(periodic, dict) else periodic
            per_vec = torch.zeros((self.ndim,), dtype=torch.float64)
            for idx, p in per.items():
                per_vec[int(idx)] = float(p)
        self.periodic_vec = per_vec

        if moves is None:
            pairs = [(StretchMove(periodic=per_vec), 1.0)]
        self.moves = [m for m, _ in pairs]
        w = np.array([float(wt) for _, wt in pairs])
        self.move_weights = w / w.sum()
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
            self.backend.reset(nwalkers, self.ndims, ntemps=self.ntemps, nleaves_max=1,
                               branch_names=self.branch_names)
        if info:
            self.backend.info.update(info)

        self.update_fn = update_fn
        self.update_iterations = update_iterations
        self.stopping_fn = stopping_fn
        self.stopping_iterations = stopping_iterations
        self.seed = int(seed)

    def _parse_prior(self, priors) -> ProbDistContainer:
        if isinstance(priors, ProbDistContainer):
            return priors
        if isinstance(priors, dict):
            if all(isinstance(k, str) for k in priors):
                v = priors[self.branch_name]
                return v if isinstance(v, ProbDistContainer) else ProbDistContainer(v)
            return ProbDistContainer(priors)
        raise ValueError("priors must be a dict or ProbDistContainer")

    # ---- model evaluation ----
    def _logp(self, x):
        return self._prior.logpdf(x)

    def _logl(self, x):
        return self.log_like_fn(x, *self.args, **self.kwargs)

    def compute_log_prior(self, coords) -> torch.Tensor:
        return self._prior.logpdf(cpu64(coords))

    def compute_log_like(self, coords, logp=None) -> torch.Tensor:
        """log L of (..., ndim) walkers: NaN -> -1e300, and -1e300 where
        ``logp`` is not finite (those walkers are not evaluated)."""
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
        coords = state.branches[self.branch_name].coords[:, :, 0, :]
        log_like, log_prior, betas = state.log_like, state.log_prior, state.betas
        seed = state.random_state
        move_info = state.move_info
        if move_info is None:
            move_info = tuple(m.init_move_state(*coords.shape) if hasattr(m, "init_move_state")
                              else None for m in self.moves)
        it0 = self.backend.iteration * thin_by
        for i in range(iterations):
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
        else:
            st = make_state(s, name=self.branch_name)
        betas = st.betas
        if betas.shape[0] != self.ntemps or (self.ntemps > 1 and bool(torch.all(betas == 1.0))):
            # raw-array initial states carry placeholder unit betas
            betas = self.temperature_control.betas.clone()
        coords = st.branches[self.branch_name].coords[:, :, 0, :]
        lp = self.compute_log_prior(coords)
        ll = st.log_like
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
