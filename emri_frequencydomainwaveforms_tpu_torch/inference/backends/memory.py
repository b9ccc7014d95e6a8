"""In-memory chain backend.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.backends.memory
.Backend``: a growable numpy store of the chain, the log-likelihoods, the
log-priors and the ladder, with the reference's getters, acceptance
counters and diagnostics (the integrated autocorrelation time of the cold
chain and the thermodynamic-integration evidence). Inactive leaves are
stored as NaN.
"""

from __future__ import annotations

import numpy as np

from ..state import State, make_state


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class Backend:
    """Growable numpy chain store with the reference's getters."""

    def __init__(self, dtype=np.float64):
        self.dtype = dtype
        self.initialized = False
        self.info = {}

    def reset(self, nwalkers, ndims, ntemps=1, nleaves_max=1, branch_names=None, **kwargs):
        self.nwalkers = nwalkers
        self.branch_names = branch_names or ["model_0"]
        if isinstance(ndims, dict):
            self.ndims = {k: int(v) for k, v in ndims.items()}
        elif isinstance(ndims, (list, tuple, np.ndarray)):
            self.ndims = {k: int(d) for k, d in zip(self.branch_names, ndims)}
        else:
            self.ndims = {k: int(ndims) for k in self.branch_names}
        self.ndim = self.ndims[self.branch_names[0]]
        self.ntemps = ntemps
        if isinstance(nleaves_max, dict):
            self.nleaves_max = {k: int(v) for k, v in nleaves_max.items()}
        elif isinstance(nleaves_max, (list, tuple, np.ndarray)):
            self.nleaves_max = {k: int(v) for k, v in zip(self.branch_names, nleaves_max)}
        else:
            self.nleaves_max = {k: int(nleaves_max) for k in self.branch_names}
        self.iteration = 0
        self._chain = {k: [] for k in self.branch_names}
        self._inds = {k: [] for k in self.branch_names}
        self._log_like = []
        self._log_prior = []
        self._betas = []
        self._accepted = np.zeros((ntemps, nwalkers))
        self._rj_accepted = np.zeros((ntemps, nwalkers))
        self._swaps_accepted = np.zeros((max(ntemps - 1, 0),))
        self._rstate = None
        self.initialized = True

    def grow(self, ngrow, blobs=None):
        pass  # python lists grow dynamically

    @staticmethod
    def _stored(branch):
        coords = _np(branch.coords)
        inds = _np(branch.inds).astype(bool)
        return np.where(inds[..., None], coords, np.nan), inds

    def _accepted_increment(self, accepted):
        acc = _np(accepted).astype(np.float64)
        if acc.ndim == 1:  # per temperature: spread over the walkers
            acc = np.broadcast_to(acc[:, None] / max(self.nwalkers, 1),
                                  (self.ntemps, self.nwalkers))
        return acc

    def save_step(self, state: State, accepted, rj_accepted=None, swap_frac=None, **kwargs):
        """Append one iteration. ``accepted`` (and ``rj_accepted``, the
        reversible-jump acceptances): accepted count per temperature
        (ntemps,) or per walker (ntemps, nwalkers); ``swap_frac``: swap
        acceptance per adjacent pair."""
        for name in self.branch_names:
            coords, inds = self._stored(state.branches[name])
            self._chain[name].append(coords)
            self._inds[name].append(inds)
        self._log_like.append(_np(state.log_like))
        self._log_prior.append(_np(state.log_prior))
        self._betas.append(_np(state.betas))
        self._accepted = self._accepted + self._accepted_increment(accepted)
        if rj_accepted is not None:
            self._rj_accepted = self._rj_accepted + self._accepted_increment(rj_accepted)
        if swap_frac is not None and len(swap_frac):
            self._swaps_accepted = self._swaps_accepted + _np(swap_frac)
        self._rstate = state.random_state
        self.iteration += 1

    # ---- getters ----
    @staticmethod
    def _stack(lst, discard=0, thin=1):
        if not lst:
            return None
        return np.stack(lst[discard::thin], axis=0)

    def get_chain(self, discard: int = 0, thin: int = 1, temp_index=None, **kwargs):
        """{branch: (nsteps, ntemps, nwalkers, nleaves_max, ndim)}."""
        out = {}
        for name in self.branch_names:
            chain = self._stack(self._chain[name], discard, thin)
            if chain is not None and temp_index is not None:
                chain = chain[:, temp_index]
            out[name] = chain
        return out

    def get_inds(self, discard: int = 0, thin: int = 1, **kwargs):
        return {name: self._stack(self._inds[name], discard, thin) for name in self.branch_names}

    def get_nleaves(self, discard: int = 0, thin: int = 1, **kwargs):
        return {name: self._stack(self._inds[name], discard, thin).sum(axis=-1)
                for name in self.branch_names}

    def get_log_like(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._stack(self._log_like, discard, thin)

    def get_log_prior(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._stack(self._log_prior, discard, thin)

    def get_betas(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._stack(self._betas, discard, thin)

    def get_value(self, name, **kwargs):
        return {
            "chain": self.get_chain,
            "log_like": self.get_log_like,
            "log_prior": self.get_log_prior,
            "betas": self.get_betas,
        }[name](**kwargs)

    def _last_state(self, chains, inds, log_like, log_prior, betas, random_state) -> State:
        coords = {name: np.where(inds[name][..., None], chains[name], 0.0) for name in chains}
        return make_state(coords, inds=inds, log_like=log_like, log_prior=log_prior,
                          betas=betas, random_state=random_state)

    def get_last_sample(self) -> State:
        """The last stored iteration as a `State` (its ``random_state`` is
        the seed of the next iteration)."""
        return self._last_state(
            {n: self._chain[n][-1] for n in self.branch_names},
            {n: self._inds[n][-1] for n in self.branch_names},
            self._log_like[-1], self._log_prior[-1], self._betas[-1], self._rstate,
        )

    @property
    def acceptance_fraction(self):
        return self._accepted / max(self.iteration, 1)

    @property
    def swap_acceptance_fraction(self):
        return self._swaps_accepted / max(self.iteration, 1)

    @property
    def rj_acceptance_fraction(self):
        """Reversible-jump acceptance per (temperature, walker); zero for a
        fixed-dimension run."""
        return self._rj_accepted / max(self.iteration, 1)

    def get_autocorr_time(self, discard: int = 0, thin: int = 1, c: float = 5.0, **kwargs):
        """{branch: integrated autocorrelation time per parameter} of the
        cold chain's first leaf (walker-averaged ACF, Sokal window ``c``)."""
        from ...utils.autocorr import get_integrated_act

        name = self.branch_names[0]
        chain = self.get_chain(discard=discard, thin=thin)[name]  # (n, T, W, L, D)
        return {name: get_integrated_act(chain[:, 0, :, 0, :], c=c)}

    def get_evidence_estimate(self, discard: int = 0, thin: int = 1, return_error: bool = True):
        """Thermodynamic-integration log evidence from the tempered ladder
        (the last stored ladder, each rung's mean log-likelihood over steps
        and walkers): ``(log Z, error estimate)`` or log Z alone."""
        from ...utils.autocorr import thermodynamic_integration_log_evidence

        logls = self.get_log_like(discard=discard, thin=thin)  # (n, T, W)
        betas = self.get_betas(discard=discard, thin=thin)[-1]
        logz, dlogz = thermodynamic_integration_log_evidence(betas, logls.mean(axis=(0, 2)))
        return (logz, dlogz) if return_error else logz


__all__ = ["Backend"]
