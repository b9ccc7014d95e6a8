"""The move contract, the Goodman-Weare stretch move and the DIME move.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.stretch``:
`StretchMove` (the red-blue split into two halves, each half's walkers
stretched toward a random partner of the other half with
``z = ((a - 1) U + 1)^2 / a``, periodic-aware differences and wrapping, and
the accept rule ``log u < (ndim - 1) log z + beta dlogL + dlogp``), and
`DIMEMove` with its carried `DIMEState` (Boehl 2022: differential-evolution
proposals mixed with adaptive multivariate-t independence proposals whose
moments remember every past ensemble).

Every move of the port is a pure function of its random draws (`Move`):
``draws(generator, shape)`` takes them from a ``torch.Generator`` in the
order its docstring states, ``step(..., draws, ...)`` applies them, and
``propose(generator, ...)`` does both. A move can so be held against the
reference on the reference's own draws. Where the reference's compiled step
fuses a multiply-add, the port fuses it too (``torch.addcmul``), and the
update is the same to the last bit.

The likelihood is evaluated only for proposals inside the prior: the
reference evaluates every proposal and then replaces the log-likelihood of
those outside by -1e300, which is what they get here without the call, so
coordinates, log-likelihoods and acceptances are the same.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ...utils.periodic import floor_mod
from ..state import cpu64

_FILL = -1e300
_F64 = torch.float64


def _uniform(generator, shape):
    return torch.rand(shape, generator=generator, dtype=_F64)


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, dtype=_F64)


def _diff(x1, x2, periods):
    d = x1 - x2
    if periods is None:
        return d
    per = torch.as_tensor(periods, dtype=d.dtype)
    safe = torch.where(per > 0, per, torch.ones_like(per))
    # d - per * round(d / per) as one fused multiply-add, as the reference's
    # compiled move rounds it
    return torch.where(per > 0, torch.addcmul(d, -per, torch.round(d / safe)), d)


def _wrap(x, periods):
    if periods is None:
        return x
    per = torch.as_tensor(periods, dtype=x.dtype)
    safe = torch.where(per > 0, per, torch.ones_like(per))
    return torch.where(per > 0, floor_mod(x, safe), x)


def evaluate(x: torch.Tensor, logp_fn: Callable, logl_fn: Callable):
    """(log prior, log L) of the (..., ndim) points ``x``, each of shape
    ``x.shape[:-1]``. ``logl_fn`` sees only the points inside the prior, in
    one call; the others, and NaN values, get -1e300."""
    flat = x.reshape(-1, x.shape[-1])
    lp = cpu64(logp_fn(flat)).reshape(-1)
    ll = torch.full_like(lp, _FILL)
    rows = torch.nonzero(torch.isfinite(lp))[:, 0]
    if rows.numel():
        ll[rows] = cpu64(logl_fn(flat[rows])).reshape(-1)
    ll = torch.where(torch.isnan(ll), _FILL, ll)
    return lp.reshape(x.shape[:-1]), ll.reshape(x.shape[:-1])


def mh_update(coords, log_like, log_prior, betas, prop, factors, u, logp_fn, logl_fn):
    """Metropolis-Hastings accept of ``prop`` (ntemps, nwalkers, ndim) with
    log proposal ratio ``factors`` and accept uniforms ``u`` (ntemps,
    nwalkers): ``log u < factors + beta dlogL + dlogp``, inside the prior
    only. Returns (coords, log_like, log_prior, accepted per temperature)."""
    lp_new, ll_new = evaluate(prop, logp_fn, logl_fn)
    lnpdiff = torch.addcmul(factors, betas[:, None], ll_new - log_like) + (lp_new - log_prior)
    accept = (torch.log(u) < lnpdiff) & torch.isfinite(lp_new)
    return (torch.where(accept[..., None], prop, coords), torch.where(accept, ll_new, log_like),
            torch.where(accept, lp_new, log_prior), accept.sum(dim=1))


class Move:
    """A move over (ntemps, nwalkers, ndim) coordinates as a pure function of
    its draws. ``logp_fn`` and ``logl_fn`` map (n, ndim) to (n,)."""

    def draws(self, generator: torch.Generator, shape: tuple):
        """The move's random draws for coordinates of ``shape``."""
        raise NotImplementedError

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        """The update on ``draws``: (coords, log_like, log_prior, accepted
        per temperature (ntemps,))."""
        raise NotImplementedError

    def propose(self, generator, coords, log_like, log_prior, betas, logp_fn, logl_fn):
        """One update, drawn from ``generator``."""
        return self.step(coords, log_like, log_prior, betas,
                         self.draws(generator, tuple(coords.shape)), logp_fn, logl_fn)


def stretch_half(
    coords: torch.Tensor,  # (ntemps, nwalkers, ndim)
    log_like: torch.Tensor,  # (ntemps, nwalkers)
    log_prior: torch.Tensor,
    betas: torch.Tensor,  # (ntemps,)
    half: int,
    z: torch.Tensor,  # (ntemps, nwalkers // 2) stretch factors
    partner: torch.Tensor,  # (ntemps, nwalkers // 2) indices into the other half
    u: torch.Tensor,  # (ntemps, nwalkers // 2) accept uniforms
    logp_fn: Callable,
    logl_fn: Callable,
    periodic=None,
):
    """Stretch the walkers of half ``half`` (0: the first nwalkers // 2).

    ``logp_fn`` and ``logl_fn`` map (n, ndim) to (n,); ``logl_fn`` sees
    only the proposals inside the prior. Returns the updated (coords, log_like, log_prior) and the accepted count per
    temperature (ntemps,) int64.
    """
    ntemps, nwalkers, ndim = coords.shape
    nh = nwalkers // 2
    s_sl = slice(half * nh, (half + 1) * nh)
    c_sl = slice((1 - half) * nh, (2 - half) * nh)
    s = coords[:, s_sl]
    c_pick = torch.gather(coords[:, c_sl], 1, partner.long()[..., None].expand(-1, -1, ndim))
    # c + z (s - c) as one fused multiply-add, as the reference's compiled
    # move rounds it (the stretch is then the same to the last bit)
    prop = _wrap(torch.addcmul(c_pick, z[..., None], _diff(s, c_pick, periodic)), periodic)
    new_s, ll_s, lp_s, acc = mh_update(s, log_like[:, s_sl], log_prior[:, s_sl], betas, prop,
                                       (ndim - 1.0) * torch.log(z), u, logp_fn, logl_fn)
    coords, log_like, log_prior = coords.clone(), log_like.clone(), log_prior.clone()
    coords[:, s_sl], log_like[:, s_sl], log_prior[:, s_sl] = new_s, ll_s, lp_s
    return coords, log_like, log_prior, acc


class StretchMove(Move):
    """Tempered stretch move over (ntemps, nwalkers, ndim) coordinates.

    Args:
      a: stretch scale.
      periodic: optional per-dimension period vector (ndim,); 0 entries are
        not periodic (the sampler fills it from its ``periodic`` mapping).
    """

    def __init__(self, a: float = 2.0, periodic=None, use_gpu=None, live_dangerously=False,
                 return_gpu=False, random_seed=None):
        del use_gpu, return_gpu, random_seed
        self.a = a
        self.periodic = periodic
        self.live_dangerously = live_dangerously

    def draws(self, generator, shape):
        """Per half, the first half first: (z, partner, u), each (ntemps,
        nwalkers // 2), drawn in that order: z = ((a - 1) U + 1)^2 / a from
        uniforms, partners in the other half, accept uniforms."""
        ntemps, nh = shape[0], shape[1] // 2
        a = self.a
        out = []
        for _ in range(2):
            z = ((a - 1.0) * _uniform(generator, (ntemps, nh)) + 1.0) ** 2 / a
            partner = torch.randint(0, nh, (ntemps, nh), generator=generator)
            out.append((z, partner, _uniform(generator, (ntemps, nh))))
        return out

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        """Both halves in turn."""
        n_acc = torch.zeros((coords.shape[0],), dtype=torch.int64)
        for half, (z, partner, u) in enumerate(draws):
            coords, log_like, log_prior, acc = stretch_half(
                coords, log_like, log_prior, betas, half, z, partner, u, logp_fn, logl_fn,
                periodic=self.periodic,
            )
            n_acc = n_acc + acc
        return coords, log_like, log_prior, n_acc


class DIMEState(NamedTuple):
    """The DIME move's carried adaptation state: the exponential-memory
    proposal moments, the log of their cumulative ensemble weight and the
    previous iteration's accepted count, which weighs the next ensemble."""

    mean: torch.Tensor  # (ndim,)
    cov: torch.Tensor  # (ndim, ndim)
    cumlweight: torch.Tensor  # scalar
    naccepted: torch.Tensor  # scalar int64


def _mvt_logpdf(x, mean, scale_cov, df, ndim):
    """Multivariate Student-t log-density of the rows of ``x`` with scale
    matrix ``scale_cov`` (already scaled by (df - 2) / df by the caller)."""
    chol = torch.linalg.cholesky(scale_cov + 1e-12 * torch.eye(ndim, dtype=_F64))
    u = torch.linalg.solve_triangular(chol, (x - mean).T, upper=False).T
    maha = torch.sum(u * u, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return (math.lgamma(0.5 * (df + ndim)) - math.lgamma(0.5 * df)
            - 0.5 * ndim * math.log(df * math.pi) - 0.5 * logdet
            - 0.5 * (df + ndim) * torch.log1p(maha / df))


def chisquare(generator, df: float, n: int) -> torch.Tensor:
    """(n,) chi-square draws with ``df`` degrees of freedom: 2 Gamma(df / 2)
    by Marsaglia and Tsang's squeeze (df >= 2), each round a normal and a
    uniform for every draw still pending, from ``generator``."""
    d = df / 2.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty((n,), dtype=_F64)
    pending = torch.arange(n)
    while pending.numel():
        x = _normal(generator, (pending.numel(),))
        u = _uniform(generator, (pending.numel(),))
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-300)))
        out[pending[ok]] = 2.0 * d * v[ok]
        pending = pending[~ok]
    return out


class DIMEMove(Move):
    """Differential-Independence Mixture Ensemble move (Boehl 2022).

    Each walker takes, with probability ``aimh_prob``, a multivariate
    Student-t independence candidate (``df_proposal_dist`` dof, scale
    ``cov (df - 2) / df``) with the exact t-density correction, else the
    differential-evolution step ``x + gamma (x_a - x_b) + sigma N(0, 1)``
    with distinct partners other than itself. The t proposal's moments are a
    log-sum-exp-weighted average over every past ensemble, each weighted by
    ``logsumexp(lprobs) + log(n_accepted) - log(nchain)``; they pool all
    temperatures. `propose_stateful` carries them in a `DIMEState` (the
    sampler threads it through ``State.move_info``); the stateless
    `propose` starts from `init_move_state` each call.
    """

    def __init__(self, sigma: float = 1.0e-5, gamma: float | None = None,
                 aimh_prob: float = 0.1, df_proposal_dist: float = 10.0,
                 periodic=None, **kwargs):
        del kwargs
        self.sigma = sigma
        self.gamma = gamma
        self.aimh_prob = aimh_prob
        self.dft = df_proposal_dist
        self.periodic = periodic

    def init_move_state(self, ntemps: int, nwalkers: int, ndim: int) -> DIMEState:
        """Unit covariance, zero mean, no weight yet and every walker counted
        as accepted."""
        return DIMEState(
            mean=torch.zeros((ndim,), dtype=_F64),
            cov=torch.eye(ndim, dtype=_F64),
            cumlweight=torch.tensor(-math.inf, dtype=_F64),
            naccepted=torch.tensor(ntemps * nwalkers, dtype=torch.int64),
        )

    def draws(self, generator, shape):
        """(i0, i1, f, sel, z, chi2, u), drawn in that order, over the
        nchain = ntemps x nwalkers walkers: i0 in [1, nchain) and i1 in
        [1, nchain - 1) (partner offsets), f (nchain,) and z (nchain, ndim)
        standard normals, sel (nchain,) uniforms choosing the t branch, chi2
        (nchain,) chi-square draws with df_proposal_dist dof, u (ntemps,
        nwalkers) accept uniforms."""
        ntemps, nwalkers, ndim = shape
        n = ntemps * nwalkers
        i0 = torch.randint(1, n, (n,), generator=generator)
        i1 = torch.randint(1, n - 1, (n,), generator=generator)
        f = _normal(generator, (n,))
        sel = _uniform(generator, (n,))
        z = _normal(generator, (n, ndim))
        chi2 = chisquare(generator, self.dft, n)
        return i0, i1, f, sel, z, chi2, _uniform(generator, (ntemps, nwalkers))

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        """The update from a fresh `init_move_state`."""
        st = self.init_move_state(*coords.shape)
        return self.step_stateful(coords, log_like, log_prior, betas, draws, logp_fn, logl_fn,
                                  st)[:4]

    def propose_stateful(self, generator, coords, log_like, log_prior, betas, logp_fn, logl_fn,
                         move_state: DIMEState):
        """One update from ``move_state``: (coords, log_like, log_prior,
        accepted per temperature, the new `DIMEState`)."""
        return self.step_stateful(coords, log_like, log_prior, betas,
                                  self.draws(generator, tuple(coords.shape)), logp_fn, logl_fn,
                                  move_state)

    def step_stateful(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn,
                      move_state: DIMEState):
        ntemps, nwalkers, ndim = coords.shape
        nchain = ntemps * nwalkers
        x = coords.reshape(nchain, ndim)
        i0, i1, f, sel, z, chi2, u = draws

        # the proposal moments, updated with this ensemble
        lprobs = (betas[:, None] * log_like + log_prior).reshape(nchain)
        lweight = (torch.logsumexp(lprobs, 0)
                   + torch.log(move_state.naccepted.clamp_min(1).to(_F64)) - math.log(nchain))
        lweight = torch.where(move_state.naccepted > 0, lweight, -math.inf)
        nmean = torch.mean(x, dim=0)
        xc = x - nmean
        ncov = (xc.T @ xc) / (nchain - 1)
        newcum = torch.logaddexp(move_state.cumlweight, lweight)
        # a -inf / -inf start weighs the old moments 0 and the new ones 1
        live = torch.isfinite(newcum)
        w_old = torch.where(live, torch.exp(move_state.cumlweight - newcum), 0.0)
        w_new = torch.where(live, torch.exp(lweight - newcum), 1.0)
        mean = w_old * move_state.mean + w_new * nmean
        cov = w_old * move_state.cov + w_new * ncov
        newcum = torch.where(live, newcum, lweight)

        # differential evolution with distinct partners other than the walker
        gamma = self.gamma if self.gamma is not None else 2.38 / math.sqrt(2.0 * ndim)
        ar = torch.arange(nchain)
        i0 = ar + i0
        i1 = ar + i1
        i1 = i1 + (i1 >= i0).long()
        q = x + gamma * (x[i0 % nchain] - x[i1 % nchain]) + (self.sigma * f)[:, None]
        factors = torch.zeros((nchain,), dtype=_F64)

        # multivariate-t independence candidates
        scale_cov = cov * (self.dft - 2.0) / self.dft
        chol = torch.linalg.cholesky(scale_cov + 1e-12 * torch.eye(ndim, dtype=_F64))
        xcand = mean + (z @ chol.T) / torch.sqrt(chi2 / self.dft)[:, None]
        lq_old = _mvt_logpdf(x, mean, scale_cov, self.dft, ndim)
        lq_new = _mvt_logpdf(xcand, mean, scale_cov, self.dft, ndim)
        xchnge = sel <= self.aimh_prob
        q = torch.where(xchnge[:, None], xcand, q)
        factors = torch.where(xchnge, lq_old - lq_new, factors)

        coords, log_like, log_prior, n_acc = mh_update(
            coords, log_like, log_prior, betas, q.reshape(ntemps, nwalkers, ndim),
            factors.reshape(ntemps, nwalkers), u, logp_fn, logl_fn)
        new_state = DIMEState(mean=mean, cov=cov, cumlweight=newcum, naccepted=n_acc.sum())
        return coords, log_like, log_prior, n_acc, new_state


__all__ = ["Move", "evaluate", "mh_update", "stretch_half", "StretchMove", "DIMEState",
           "DIMEMove", "chisquare"]
