"""Goodman-Weare affine-invariant stretch move, tempered.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.stretch
.StretchMove``: the red-blue split into two halves, each half's walkers
stretched toward a random partner of the other half with
``z = ((a - 1) U + 1)^2 / a``, periodic-aware differences and wrapping, and
the accept rule ``log u < (ndim - 1) log z + beta dlogL + dlogp``.

`stretch_half` is the update of one half as a pure function of its random
draws (z, partner, u), so it can be held against the reference on the
reference's own draws; `StretchMove.propose` draws them from a
``torch.Generator`` (per half: z's uniforms, the partners, the accept
uniforms, in that order).

The likelihood is evaluated only for proposals inside the prior: the
reference evaluates every proposal and then replaces the log-likelihood of
those outside by -1e300, which is what they get here without the call, so
coordinates, log-likelihoods and acceptances are the same.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...utils.periodic import floor_mod
from ..state import cpu64

_FILL = -1e300


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

    flat = prop.reshape(-1, ndim)
    lp_new = cpu64(logp_fn(flat)).reshape(ntemps, nh)
    inside = torch.isfinite(lp_new)
    ll_new = torch.full((ntemps * nh,), _FILL, dtype=torch.float64)
    rows = torch.nonzero(inside.reshape(-1))[:, 0]
    if rows.numel():
        ll_new[rows] = cpu64(logl_fn(flat[rows])).reshape(-1)
    ll_new = ll_new.reshape(ntemps, nh)
    ll_new = torch.where(torch.isnan(ll_new), _FILL, ll_new)

    ll_s, lp_s = log_like[:, s_sl], log_prior[:, s_sl]
    lnpdiff = torch.addcmul((ndim - 1.0) * torch.log(z), betas[:, None], ll_new - ll_s) + (
        lp_new - lp_s)
    accept = (torch.log(u) < lnpdiff) & inside

    coords, log_like, log_prior = coords.clone(), log_like.clone(), log_prior.clone()
    coords[:, s_sl] = torch.where(accept[..., None], prop, s)
    log_like[:, s_sl] = torch.where(accept, ll_new, ll_s)
    log_prior[:, s_sl] = torch.where(accept, lp_new, lp_s)
    return coords, log_like, log_prior, accept.sum(dim=1)


class StretchMove:
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

    def draws(self, generator: torch.Generator, ntemps: int, nh: int):
        """(z, partner, u) of one half, each (ntemps, nh)."""
        a = self.a
        z = ((a - 1.0) * torch.rand((ntemps, nh), generator=generator, dtype=torch.float64)
             + 1.0) ** 2 / a
        partner = torch.randint(0, nh, (ntemps, nh), generator=generator)
        u = torch.rand((ntemps, nh), generator=generator, dtype=torch.float64)
        return z, partner, u

    def propose(self, generator, coords, log_like, log_prior, betas, logp_fn, logl_fn):
        """One full stretch update (both halves). Returns (coords, log_like,
        log_prior, n_accepted (ntemps,))."""
        ntemps, nwalkers, _ = coords.shape
        n_acc = torch.zeros((ntemps,), dtype=torch.int64)
        for half in (0, 1):
            z, partner, u = self.draws(generator, ntemps, nwalkers // 2)
            coords, log_like, log_prior, acc = stretch_half(
                coords, log_like, log_prior, betas, half, z, partner, u, logp_fn, logl_fn,
                periodic=self.periodic,
            )
            n_acc = n_acc + acc
        return coords, log_like, log_prior, n_acc


__all__ = ["stretch_half", "StretchMove"]
