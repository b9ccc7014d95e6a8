"""The first sampler step of a `pe_sampler` window, replayed from its input
state: the tempered Goodman-Weare stretch move (Foreman-Mackey et al. 2013,
with parallel tempering as in Vousden et al. 2016) drawn from the step's
seed in the order the port's sampler documents (per half, first half first:
z = ((a - 1) U + 1)^2 / a, a partner in the other half, an accept uniform;
one ``torch.Generator`` seeded with the state's ``random_state``).

Each half's walkers are stretched toward their partners, c + z (x - c),
with periodic differences and wrapping; a proposal inside the prior is
accepted where log u < (ndim - 1) ln z + beta (log L' - log L) + (log p' -
log p). The replay takes each proposal's log L from the program's own
likelihood calls (the numbers the sampler saw; the templates and log L
themselves are compared with the reference apart), so that the accept
decisions are the program's to the bit. It checks the proposals of both
halves against the rows the program evaluated, and the walkers after the
move against the step's result, whose temperature swaps may only exchange
walkers between temperatures.
"""

from __future__ import annotations

import math

import torch

_FILL = -1e300


def _log_prior(x, bounds):
    lo, hi = bounds[:, 0], bounds[:, 1]
    inside = ((x >= lo) & (x <= hi)).all(dim=-1)
    return torch.where(inside, -torch.log(hi - lo).sum(), torch.tensor(-math.inf, dtype=x.dtype))


def _diff(d, per):
    safe = torch.where(per > 0, per, torch.ones_like(per))
    return torch.where(per > 0, torch.addcmul(d, -per, torch.round(d / safe)), d)


def _wrap(x, per):
    safe = torch.where(per > 0, per, torch.ones_like(per))
    r = torch.fmod(x, safe)
    r = torch.where((r != 0) & ((r < 0) != (safe < 0)), r + safe, r)
    return torch.where(per > 0, r, x)


def replay(coords, log_like, betas, seed, calls, bounds, periods, a=2.0):
    """The move of one step: (proposal rows of each half inside the prior,
    the walkers after the move (coords, log L)). ``calls``: the step's
    likelihood calls, (rows, log L) each, in order: one for each half that
    has a proposal inside the prior."""
    coords, log_like = coords.clone(), log_like.clone()
    ntemps, nwalkers, ndim = coords.shape
    nh = nwalkers // 2
    bounds = torch.as_tensor(bounds, dtype=torch.float64)
    per = torch.as_tensor(periods, dtype=torch.float64)
    gen = torch.Generator().manual_seed(int(seed))
    draws = []
    for _ in range(2):
        z = ((a - 1.0) * torch.rand((ntemps, nh), generator=gen, dtype=torch.float64) + 1.0) ** 2 / a
        partner = torch.randint(0, nh, (ntemps, nh), generator=gen)
        draws.append((z, partner, torch.rand((ntemps, nh), generator=gen, dtype=torch.float64)))
    log_prior = _log_prior(coords, bounds)
    proposals, calls = [], list(calls)
    for half, (z, partner, u) in enumerate(draws):
        s_sl = slice(half * nh, (half + 1) * nh)
        c_sl = slice((1 - half) * nh, (2 - half) * nh)
        s = coords[:, s_sl]
        c = torch.gather(coords[:, c_sl], 1, partner[..., None].expand(-1, -1, ndim))
        prop = _wrap(torch.addcmul(c, z[..., None], _diff(s - c, per)), per)
        lp_new = _log_prior(prop, bounds)
        inside = torch.isfinite(lp_new)
        proposals.append(prop[inside])
        ll_new = torch.full((ntemps, nh), _FILL, dtype=torch.float64)
        call_ll = calls.pop(0)[1] if bool(inside.any()) and calls else []
        if len(call_ll) == int(inside.sum()):
            ll_new[inside] = torch.as_tensor(call_ll, dtype=torch.float64)
        ll_new = torch.where(torch.isnan(ll_new), _FILL, ll_new)
        lnpdiff = (torch.addcmul((ndim - 1.0) * torch.log(z), betas[:, None],
                                 ll_new - log_like[:, s_sl]) + (lp_new - log_prior[:, s_sl]))
        accept = (torch.log(u) < lnpdiff) & inside
        coords[:, s_sl] = torch.where(accept[..., None], prop, s)
        log_like[:, s_sl] = torch.where(accept, ll_new, log_like[:, s_sl])
        log_prior[:, s_sl] = torch.where(accept, lp_new, log_prior[:, s_sl])
    return proposals, coords, log_like


def _rows(coords, log_like):
    """The walkers as a sorted (n, ndim + 1) array of (coords, log L)."""
    rows = torch.cat([coords.reshape(-1, coords.shape[-1]), log_like.reshape(-1, 1)], dim=1)
    order = sorted(range(rows.shape[0]), key=lambda i: tuple(rows[i].tolist()))
    return rows[order]


def mismatches(step) -> int:
    """Values of the program's first step that the replay does not give to
    the bit: its two calls' proposal rows, and its walkers (coords, log L)
    after the step, as a set across temperatures. A count or shape that
    differs counts every value of it."""
    proposals, coords, log_like = replay(step["coords"], step["log_like"], step["betas"],
                                         step["seed"], step["calls"], step["bounds"],
                                         step["periods"])
    bad = 0
    calls = [torch.as_tensor(x, dtype=torch.float64) for x, _ in step["calls"]]
    for want in proposals:
        got = calls.pop(0) if len(want) and calls else torch.zeros((0, want.shape[-1]))
        bad += int((want != got).sum()) if want.shape == got.shape else max(want.numel(), got.numel())
    bad += sum(c.numel() for c in calls)
    want, got = _rows(coords, log_like), _rows(step["coords_after"], step["log_like_after"])
    bad += int((want != got).sum()) if want.shape == got.shape else want.numel()
    return bad
