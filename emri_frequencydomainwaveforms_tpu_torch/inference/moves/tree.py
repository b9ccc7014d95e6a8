"""Multi-branch (tree) in-model moves over dicts of branches.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.tree``:
`TreeStretchMove` (one stretch factor z per walker across every branch,
the partner drawn from the complement half, the Jacobian exponent counting
the dimensions active in both the walker and its partner) and
`TreeGaussianMove` (a scalar, diagonal or full covariance per branch), both
with random-scan Gibbs over branch groups (``gibbs_branches``).

The tree contract, the tree analogue of the flat one:

  propose(generator, coords: {branch: (T, W, L_b, d_b)}, inds: {branch:
  (T, W, L_b) bool}, log_like, log_prior, betas, logp_fn, logl_fn)
    -> (coords, inds, log_like, log_prior, accepted per temperature (T,))

``logp_fn(coords, inds)`` and ``logl_fn(coords, inds)`` map trees with any
two leading axes (T', W') to (T', W'), as in the reference. Each move is a
pure function of its draws (``draws(generator, coords)``, then ``step``).
`tree_loglike` calls ``logl_fn`` once per proposal, on only the walkers
whose value the move's result can depend on, packed as a (1, n) batch; the
others get -1e300, which is what the reference stores for them or what it
never reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.periodic import floor_mod
from ..state import cpu64
from .stretch import _normal, _uniform

_FILL = -1e300
_F64 = torch.float64


def tree_shapes(coords) -> tuple[int, int]:
    """(ntemps, nwalkers) of a tree (or of one branch's array)."""
    first = next(iter(coords.values())) if isinstance(coords, dict) else coords
    return first.shape[0], first.shape[1]


def _rows(x, idx):
    """The walkers ``idx`` of the flattened (T, W) axes of a tree or an
    array, as a (1, n, ...) batch."""
    if isinstance(x, dict):
        return {k: _rows(v, idx) for k, v in x.items()}
    return x.reshape((-1,) + tuple(x.shape[2:]))[idx][None]


def tree_loglike(logl_fn, coords, inds, need) -> torch.Tensor:
    """log L (T, W) of a tree (or one branch's arrays): one ``logl_fn`` call
    on the walkers where ``need`` is True; -1e300 elsewhere and for NaN."""
    shape = need.shape
    ll = torch.full((need.numel(),), _FILL, dtype=_F64)
    idx = torch.nonzero(need.reshape(-1))[:, 0]
    if idx.numel():
        ll[idx] = cpu64(logl_fn(_rows(coords, idx), _rows(inds, idx))).reshape(-1)
    return torch.where(torch.isnan(ll), _FILL, ll).reshape(shape)


def tree_evaluate(coords, inds, logp_fn, logl_fn, need=None):
    """(log prior, log L), each (T, W), of a proposed tree: the prior of
    every walker, the likelihood of those inside it (and in ``need``)."""
    lp = cpu64(logp_fn(coords, inds))
    inside = torch.isfinite(lp) if need is None else torch.isfinite(lp) & need
    return lp, tree_loglike(logl_fn, coords, inds, inside)


def _branches_on(names, gibbs_branches, g):
    """Which branches a Gibbs draw ``g`` moves (all without Gibbs)."""
    if gibbs_branches is None:
        return {name: True for name in names}
    return {name: name in gibbs_branches[g] for name in names}


class TreeMove:
    """A tree-contract move as a pure function of its draws."""

    def draws(self, generator: torch.Generator, coords: dict):
        raise NotImplementedError

    def step(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        raise NotImplementedError

    def propose(self, generator, coords, inds, log_like, log_prior, betas, logp_fn, logl_fn):
        """One update, drawn from ``generator``."""
        return self.step(coords, inds, log_like, log_prior, betas, self.draws(generator, coords),
                         logp_fn, logl_fn)


class _Periodic:
    def _periods(self, name):
        per = self.periodic.get(name)
        return None if per is None else torch.as_tensor(per, dtype=_F64)

    def _wrap(self, name, x):
        per = self._periods(name)
        if per is None:
            return x
        return torch.where(per > 0, floor_mod(x, torch.where(per > 0, per, 1.0)), x)


class TreeStretchMove(_Periodic, TreeMove):
    """Affine-invariant stretch over every branch's active leaves.

    ``periodic``: {branch: (d_b,) periods, 0 where not periodic};
    ``gibbs_branches``: a list of branch-name tuples, of which each call
    moves one, drawn uniformly (None: every branch).
    """

    def __init__(self, a: float = 2.0, periodic: dict | None = None,
                 gibbs_branches: list | None = None, **kwargs):
        del kwargs
        self.a = a
        self.periodic = periodic or {}
        self.gibbs_branches = gibbs_branches

    def _diff(self, name, x1, x2):
        d = x1 - x2
        per = self._periods(name)
        if per is None:
            return d
        wrapped = d - per * torch.round(d / torch.where(per > 0, per, 1.0))
        return torch.where(per > 0, wrapped, d)

    def draws(self, generator, coords):
        """The Gibbs group index (an int, drawn only with
        ``gibbs_branches``, else None), then per half, the first half first,
        (z, partner, u), each (ntemps, nwalkers // 2), drawn in that order:
        z = ((a - 1) U + 1)^2 / a, partners in the other half, accept
        uniforms."""
        ntemps, nwalkers = tree_shapes(coords)
        nh, a = nwalkers // 2, self.a
        g = None
        if self.gibbs_branches is not None:
            g = int(torch.randint(0, len(self.gibbs_branches), (), generator=generator))
        halves = []
        for _ in range(2):
            z = ((a - 1.0) * _uniform(generator, (ntemps, nh)) + 1.0) ** 2 / a
            partner = torch.randint(0, nh, (ntemps, nh), generator=generator)
            halves.append((z, partner, _uniform(generator, (ntemps, nh))))
        return g, halves

    def step(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        g, halves = draws
        names = list(coords)
        on = _branches_on(names, self.gibbs_branches, g)
        ntemps, nwalkers = tree_shapes(coords)
        nh = nwalkers // 2
        coords = {name: c.clone() for name, c in coords.items()}
        log_like, log_prior = log_like.clone(), log_prior.clone()
        n_acc = torch.zeros((ntemps,), dtype=torch.int64)
        for half, (z, partner, u) in enumerate(halves):
            s_sl = slice(half * nh, (half + 1) * nh)
            c_sl = slice((1 - half) * nh, (2 - half) * nh)
            prop, half_inds = {}, {}
            d_moved = torch.zeros((ntemps, nh), dtype=_F64)
            for name in names:
                c, ind = coords[name], inds[name]
                nl, d_b = c.shape[2], c.shape[3]
                s = c[:, s_sl]
                c_pick = torch.gather(c[:, c_sl], 1,
                                      partner[..., None, None].expand(-1, -1, nl, d_b))
                ic_pick = torch.gather(ind[:, c_sl], 1, partner[..., None].expand(-1, -1, nl))
                move_mask = ind[:, s_sl] & ic_pick & on[name]
                moved = self._wrap(name, c_pick + z[..., None, None] * self._diff(name, s, c_pick))
                prop[name] = torch.where(move_mask[..., None], moved, s)
                half_inds[name] = ind[:, s_sl]
                d_moved = d_moved + move_mask.sum(dim=-1) * d_b
            # a walker with no dimension moved never accepts: no call for it
            lp_new, ll_new = tree_evaluate(prop, half_inds, logp_fn, logl_fn, need=d_moved > 0)
            ll_s, lp_s = log_like[:, s_sl], log_prior[:, s_sl]
            factors = torch.where(d_moved > 0, (d_moved - 1.0) * torch.log(z), 0.0)
            lnpdiff = factors + betas[:, None] * (ll_new - ll_s) + (lp_new - lp_s)
            accept = (torch.log(u) < lnpdiff) & torch.isfinite(lp_new) & (d_moved > 0)
            for name in names:
                coords[name][:, s_sl] = torch.where(accept[..., None, None], prop[name],
                                                    coords[name][:, s_sl])
            log_like[:, s_sl] = torch.where(accept, ll_new, ll_s)
            log_prior[:, s_sl] = torch.where(accept, lp_new, lp_s)
            n_acc = n_acc + accept.sum(dim=1)
        return coords, dict(inds), log_like, log_prior, n_acc


class TreeGaussianMove(_Periodic, TreeMove):
    """Gaussian random-walk MH over every branch's active leaves.

    ``cov``: {branch: scalar | (d,) diagonal | (d, d) full covariance} (the
    full one through its Cholesky factor); ``periodic`` and
    ``gibbs_branches`` as for `TreeStretchMove`.
    """

    def __init__(self, cov: dict, periodic: dict | None = None,
                 gibbs_branches: list | None = None, **kwargs):
        del kwargs
        self.periodic = periodic or {}
        self.gibbs_branches = gibbs_branches
        self._chol = {}
        for name, c in cov.items():
            c = np.asarray(c, dtype=np.float64)
            if c.ndim == 2:
                self._chol[name] = ("full", torch.from_numpy(np.linalg.cholesky(c)))
            else:
                self._chol[name] = ("diag", torch.as_tensor(np.sqrt(c)))

    def draws(self, generator, coords):
        """The Gibbs group index (as for `TreeStretchMove`), a standard
        normal per branch of its coords' shape in branch order, then the
        accept uniforms (ntemps, nwalkers)."""
        g = None
        if self.gibbs_branches is not None:
            g = int(torch.randint(0, len(self.gibbs_branches), (), generator=generator))
        eps = {name: _normal(generator, tuple(c.shape)) for name, c in coords.items()}
        return g, eps, _uniform(generator, tree_shapes(coords))

    def step(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        g, eps, u = draws
        on = _branches_on(list(coords), self.gibbs_branches, g)
        prop = {}
        for name, c in coords.items():
            kind, fac = self._chol[name]
            step = eps[name] @ fac.T if kind == "full" else eps[name] * fac
            mask = (inds[name] & on[name])[..., None]
            prop[name] = self._wrap(name, torch.where(mask, c + step, c))
        lp_new, ll_new = tree_evaluate(prop, inds, logp_fn, logl_fn)
        lnpdiff = betas[:, None] * (ll_new - log_like) + (lp_new - log_prior)
        accept = (torch.log(u) < lnpdiff) & torch.isfinite(lp_new)
        coords = {name: torch.where(accept[..., None, None], prop[name], c)
                  for name, c in coords.items()}
        return (coords, dict(inds), torch.where(accept, ll_new, log_like),
                torch.where(accept, lp_new, log_prior), accept.sum(dim=1))


__all__ = ["TreeMove", "TreeStretchMove", "TreeGaussianMove", "tree_shapes", "tree_loglike",
           "tree_evaluate"]
