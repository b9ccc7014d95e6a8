"""Stopping and update hooks for the ensemble sampler.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.stopping``:
`SearchConvergeStopping` (stop when the max log-likelihood plateaus),
`AutoCorrelationStop` (stop when the chain exceeds N autocorrelation times
and the estimate has settled), `SNRStop` and the update hook
`AdjustStretchProposalScale` (move the stretch ``a`` toward a target
acceptance). They run through `EnsembleSampler`'s ``stopping_fn`` /
``update_fn`` hooks and read the host-side chain.
"""

from __future__ import annotations

import numpy as np


class SearchConvergeStopping:
    """Stop when max log-likelihood hasn't improved for ``n_iters`` checks."""

    def __init__(self, n_iters: int = 30, diff: float = 0.01, verbose: bool = False):
        self.n_iters = n_iters
        self.diff = diff
        self.verbose = verbose
        self.best = -np.inf
        self.iters_consecutive = 0

    def __call__(self, iteration, sample, sampler) -> bool:
        max_ll = float(np.max(np.asarray(sample.log_like)))
        if max_ll > self.best + self.diff:
            self.best = max_ll
            self.iters_consecutive = 0
        else:
            self.iters_consecutive += 1
        if self.verbose:
            print(
                f"iter {iteration}: max logl {max_ll:.3f} "
                f"(best {self.best:.3f}, stall {self.iters_consecutive}/{self.n_iters})"
            )
        return self.iters_consecutive >= self.n_iters


class AutoCorrelationStop:
    """Stop once the chain length exceeds ``factor`` integrated ACTs and the
    ACT estimate has stabilized."""

    def __init__(self, factor: float = 50.0, change_tol: float = 0.01, verbose: bool = False):
        self.factor = factor
        self.change_tol = change_tol
        self.verbose = verbose
        self.last_tau = None

    def __call__(self, iteration, sample, sampler) -> bool:
        try:
            tau_d = sampler.get_autocorr_time(discard=0)
            tau = float(np.max(list(tau_d.values())[0]))
        except Exception:
            return False
        n = sampler.backend.iteration
        converged = n > self.factor * tau
        stable = (
            self.last_tau is not None
            and abs(self.last_tau - tau) / max(tau, 1e-30) < self.change_tol
        )
        if self.verbose:
            print(f"iter {iteration}: tau {tau:.1f}, n {n}, converged {converged and stable}")
        self.last_tau = tau
        return bool(converged and stable)


class SNRStop:
    """Stop when the best walker reaches a target matched-filter SNR
    (log L ~ -SNR^2 residual form)."""

    def __init__(self, snr_target: float):
        self.snr_target = snr_target

    def __call__(self, iteration, sample, sampler) -> bool:
        max_ll = float(np.max(np.asarray(sample.log_like)))
        return max_ll > -0.5 * self.snr_target**2 * 0.01


class AdjustStretchProposalScale:
    """Update hook: adapt the stretch ``a`` toward a target acceptance."""

    def __init__(
        self,
        target_acceptance: float = 0.25,
        supression_factor: float = 0.1,
        max_change: float = 0.5,
        a_min: float = 1.1,
        a_max: float = 10.0,
    ):
        self.target = target_acceptance
        self.supression = supression_factor
        self.max_change = max_change
        self.a_min = a_min
        self.a_max = a_max

    def __call__(self, iteration, sample, sampler) -> None:
        acc = float(np.mean(sampler.acceptance_fraction))
        move = sampler.move
        change = self.supression * (acc - self.target) / max(self.target, 1e-6)
        change = float(np.clip(change, -self.max_change, self.max_change))
        # the next proposal reads the new scale (the sampler is not traced)
        move.a = float(np.clip(move.a * (1.0 + change), self.a_min, self.a_max))


__all__ = [
    "SearchConvergeStopping",
    "AutoCorrelationStop",
    "SNRStop",
    "AdjustStretchProposalScale",
]
