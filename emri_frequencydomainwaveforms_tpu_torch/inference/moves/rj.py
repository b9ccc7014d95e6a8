"""Reversible-jump birth / death moves with prior-draw births.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.rj``:
`DistributionGenerateRJ` and `DelayedRejectionRJ`. One call makes one
birth-or-death proposal per walker (per branch, the branches in turn):

  * birth: a uniformly chosen inactive slot becomes active at a prior
    draw; the factors are log(n_inactive) - log(n_active + 1);
  * death: a uniformly chosen active slot becomes inactive; the factors
    are log(n_active) - log(n_inactive + 1);

(``max(., 1)`` inside the logs), and the prior density of a born leaf
cancels its proposal density, so ``lnpdiff = factors + beta dlogL``. The
slot is the argmax of uniforms masked to -inf; the born leaf is
``min + u (max - min)`` per parameter. As in the reference, the proposal's
log-likelihood is not masked by the prior, so every walker whose
birth or death is legal is evaluated.

The state is ``coords (T, W, nleaves_max, ndim)`` with boolean ``inds``;
``logl_fn(coords, inds)`` maps any two leading axes (T', W') to (T', W')
(`moves.tree`). Each move is a pure function of its draws.
"""

from __future__ import annotations

import torch

from ..state import cpu64
from .stretch import _uniform
from .tree import tree_loglike

_F64 = torch.float64


def leaf_counts(inds, nleaves_min, nleaves_max):
    """(n_active, can_birth, can_death) of each walker."""
    n_active = inds.sum(dim=-1)
    return n_active, n_active < nleaves_max, n_active > nleaves_min


def birth_death_slot(inds, do_birth, u_slot):
    """The slot each walker proposes to fill (birth) or empty (death), as a
    boolean one-hot (T, W, L): the argmax of ``u_slot`` over the inactive,
    resp. active, slots."""
    slot = torch.where(do_birth, torch.argmax(torch.where(inds, -torch.inf, u_slot), dim=-1),
                       torch.argmax(torch.where(inds, u_slot, -torch.inf), dim=-1))
    return torch.nn.functional.one_hot(slot, inds.shape[-1]).to(torch.bool), slot


def combinatorics(n_active, nleaves_max):
    """(birth factors, death factors), the slot-choice log ratios."""
    n_active = n_active.to(_F64)
    n_inactive = nleaves_max - n_active
    birth = torch.log(torch.clamp_min(n_inactive, 1.0)) - torch.log(n_active + 1.0)
    death = torch.log(torch.clamp_min(n_active, 1.0)) - torch.log(n_inactive + 1.0)
    return birth, death


def branch_value(value, name):
    return value[name] if isinstance(value, dict) else value


def patched(tree, name, value):
    """``tree`` with branch ``name`` replaced by ``value``; the other
    branches repeat each walker to match ``value``'s walker axis (a
    multiple-try cloud folds its tries into that axis)."""
    out = {}
    for k, v in tree.items():
        if k == name:
            out[k] = value
        elif v.shape[1] == value.shape[1]:
            out[k] = v
        else:
            out[k] = v.repeat_interleave(value.shape[1] // v.shape[1], dim=1)
    return out


def branch_functions(coords, inds, name, logp_fn, logl_fn):
    """(log L, log prior) of branch ``name``'s arrays in the tree: log L
    ``(c_b, i_b, need) -> (T, W)``, log prior ``(c_b, i_b) -> (T, W)``."""
    def loglike(c_b, i_b, need):
        return tree_loglike(logl_fn, patched(coords, name, c_b), patched(inds, name, i_b), need)

    def logprior(c_b, i_b):
        return cpu64(logp_fn(patched(coords, name, c_b), patched(inds, name, i_b)))

    return loglike, logprior


class DistributionGenerateRJ:
    """Prior-draw RJ birth / death.

    ``prior``: a `ProbDistContainer` (bare arrays, `propose`) or a dict of
    them per branch (`propose_tree`, the form ``EnsembleSampler(rj_moves=
    ...)`` runs); ``nleaves_min`` / ``nleaves_max``: ints or dicts per
    branch.
    """

    def __init__(self, prior, nleaves_min=0, nleaves_max=1):
        self.prior = prior
        self.nleaves_min = nleaves_min
        self.nleaves_max = nleaves_max

    def _make_sub(self, prior_b, lo, hi):
        """The one-branch mover of `propose_tree`."""
        return DistributionGenerateRJ(prior_b, nleaves_min=lo, nleaves_max=hi)

    def branch_draws(self, generator, shape):
        """For one branch's coords ``shape`` (T, W, L, D): the birth-or-death
        uniforms (T, W), the slot uniforms (T, W, L), the born leaf's
        unit-cube point (T, W, D) and the accept uniforms (T, W), drawn in
        that order."""
        t, w, nl, d = shape
        return (_uniform(generator, (t, w)), _uniform(generator, (t, w, nl)),
                _uniform(generator, (t, w, d)), _uniform(generator, (t, w)))

    def draws(self, generator, coords: dict):
        """`branch_draws` of every branch, in branch order."""
        return [self.branch_draws(generator, tuple(c.shape)) for c in coords.values()]

    def propose_tree(self, generator, coords: dict, inds: dict, log_like, log_prior, betas,
                     logp_fn, logl_fn):
        """The tree contract: each branch's birth / death in turn, each
        accepted on its own. Returns (coords, inds, log_like, log_prior,
        accepted per temperature, summed over the branches)."""
        return self.step_tree(coords, inds, log_like, log_prior, betas,
                              self.draws(generator, coords), logp_fn, logl_fn)

    def step_tree(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        priors = self.prior if isinstance(self.prior, dict) else {next(iter(coords)): self.prior}
        coords, inds = dict(coords), dict(inds)
        n_total = None
        for name, draw in zip(list(coords), draws):
            sub = self._make_sub(priors[name], branch_value(self.nleaves_min, name),
                                 branch_value(self.nleaves_max, name))
            loglike, logprior = branch_functions(coords, inds, name, logp_fn, logl_fn)
            coords[name], inds[name], log_like, log_prior, n_acc = sub._step_branch(
                coords[name], inds[name], log_like, log_prior, betas, draw, loglike, logprior)
            n_total = n_acc if n_total is None else n_total + n_acc
        return coords, inds, log_like, log_prior, n_total

    def propose(self, generator, coords, inds, log_like, log_prior, betas, logl_fn):
        """Bare arrays: ``coords`` (T, W, L, D), ``inds`` (T, W, L),
        ``logl_fn(coords, inds) -> (T', W')``; the log prior is the sum of
        ``prior.logpdf`` over the active leaves."""
        return self.step(coords, inds, log_like, log_prior, betas,
                         self.branch_draws(generator, tuple(coords.shape)), logl_fn)

    def step(self, coords, inds, log_like, log_prior, betas, draws, logl_fn):
        """`propose` on its `branch_draws`."""
        def loglike(c, i, need):
            return tree_loglike(logl_fn, c, i, need)

        return self._step_branch(coords, inds, log_like, log_prior, betas, draws, loglike,
                                 self._leaf_logprior)

    def _proposal(self, coords, inds, do_birth, onehot, u_draw):
        """The birth-or-death tree of each walker: (coords, inds)."""
        new_leaf = self._ppf(u_draw)
        inds_new = torch.where(do_birth[..., None], inds | onehot, inds & ~onehot)
        coords_new = torch.where((do_birth[..., None] & onehot)[..., None],
                                 new_leaf[..., None, :], coords)
        return coords_new, inds_new

    def _step_branch(self, coords, inds, log_like, log_prior, betas, draws, loglike, logprior):
        u_bd, u_slot, u_draw, u = draws
        n_active, can_birth, can_death = leaf_counts(inds, self.nleaves_min, self.nleaves_max)
        do_birth = torch.where(can_birth & can_death, u_bd < 0.5, can_birth)
        onehot, _ = birth_death_slot(inds, do_birth, u_slot)
        legal = torch.where(do_birth, can_birth, can_death)
        coords_new, inds_new = self._proposal(coords, inds, do_birth, onehot, u_draw)
        lp_new = logprior(coords_new, inds_new)
        ll_new = loglike(coords_new, inds_new, legal)
        f_birth, f_death = combinatorics(n_active, inds.shape[-1])
        lnpdiff = torch.where(do_birth, f_birth, f_death) + betas[:, None] * (ll_new - log_like)
        accept = (torch.log(u) < lnpdiff) & legal
        return (torch.where(accept[..., None, None], coords_new, coords),
                torch.where(accept[..., None], inds_new, inds),
                torch.where(accept, ll_new, log_like), torch.where(accept, lp_new, log_prior),
                accept.sum(dim=1))

    def _ppf(self, u):
        cols = []
        for i in range(u.shape[-1]):
            dist = self.prior.priors_in.get(i)
            if dist is None or not hasattr(dist, "min_val"):
                raise NotImplementedError("RJ prior draws need per-index uniform-like dists")
            cols.append(dist.min_val + u[..., i] * (dist.max_val - dist.min_val))
        return torch.stack(cols, dim=-1)

    def _leaf_logprior(self, coords, inds):
        return torch.sum(torch.where(inds, self.prior.logpdf(coords), 0.0), dim=-1)


class DelayedRejectionRJ(DistributionGenerateRJ):
    """RJ birth / death with delayed rejection on rejected births.

    After the birth / death stage, a walker whose birth was rejected draws
    the born leaf again, up to ``max_iter`` times, each stage accepted with
    the Tierney-Mira recursion

      alpha_1(y_k)  = min(1, exp(lndiff_k))
      dr_alpha(y_k) = min(1, exp(lndiff_k + log(1 - alpha_1(y_k))
                                          - log(1 - past_alpha)))

    with ``past_alpha`` the previous stage's dr_alpha (stage 0: its plain
    acceptance probability), both clipped at 1 - 1e-12, and a NaN dr_alpha
    counted as 0. Every stage makes its draws; each evaluates only the
    walkers still in delayed rejection.
    """

    def __init__(self, prior, nleaves_min=0, nleaves_max=1, max_iter: int = 5):
        super().__init__(prior, nleaves_min=nleaves_min, nleaves_max=nleaves_max)
        self.max_iter = int(max_iter)

    def _make_sub(self, prior_b, lo, hi):
        return DelayedRejectionRJ(prior_b, nleaves_min=lo, nleaves_max=hi,
                                  max_iter=self.max_iter)

    def branch_draws(self, generator, shape):
        """Stage 0's draws (as `DistributionGenerateRJ.branch_draws`), then
        per stage the born leaf's unit-cube point (T, W, D) and the accept
        uniforms (T, W)."""
        t, w, _, d = shape
        first = super().branch_draws(generator, shape)
        return first, [(_uniform(generator, (t, w, d)), _uniform(generator, (t, w)))
                       for _ in range(self.max_iter)]

    def _step_branch(self, coords, inds, log_like, log_prior, betas, draws, loglike, logprior):
        (u_bd, u_slot, u_draw, u), stages = draws
        n_active, can_birth, can_death = leaf_counts(inds, self.nleaves_min, self.nleaves_max)
        do_birth = torch.where(can_birth & can_death, u_bd < 0.5, can_birth)
        onehot, _ = birth_death_slot(inds, do_birth, u_slot)
        f_birth, f_death = combinatorics(n_active, inds.shape[-1])
        factors = torch.where(do_birth, f_birth, f_death)
        legal = torch.where(do_birth, can_birth, can_death)

        def candidate(u_draw_k, need):
            c_k, i_k = self._proposal(coords, inds, do_birth, onehot, u_draw_k)
            ll_k = loglike(c_k, i_k, need)
            return c_k, i_k, ll_k, logprior(c_k, i_k), factors + betas[:, None] * (ll_k - log_like)

        c_new, i_new, ll_new, lp_new, lndiff = candidate(u_draw, legal)
        accept = (torch.log(u) < lndiff) & legal
        out_c = torch.where(accept[..., None, None], c_new, coords)
        out_i = torch.where(accept[..., None], i_new, inds)
        out_ll = torch.where(accept, ll_new, log_like)
        out_lp = torch.where(accept, lp_new, log_prior)

        # the stages, on the rejected births only
        past_alpha = torch.clamp(torch.exp(torch.clamp_max(lndiff, 0.0)), 0.0, 1.0 - 1e-12)
        in_dr = ~accept & do_birth & legal
        for u_draw_k, u_k in stages:
            c_k, i_k, ll_k, lp_k, lndiff_k = candidate(u_draw_k, in_dr)
            alpha_1 = torch.clamp(torch.exp(torch.clamp_max(lndiff_k, 0.0)), 0.0, 1.0 - 1e-12)
            log_dr = lndiff_k + torch.log1p(-alpha_1) - torch.log1p(-past_alpha)
            dr_alpha = torch.clamp(torch.exp(torch.clamp_max(log_dr, 0.0)), 0.0, 1.0)
            dr_alpha = torch.where(torch.isnan(dr_alpha), 0.0, dr_alpha)
            acc_k = in_dr & (u_k < dr_alpha)
            out_c = torch.where(acc_k[..., None, None], c_k, out_c)
            out_i = torch.where(acc_k[..., None], i_k, out_i)
            out_ll = torch.where(acc_k, ll_k, out_ll)
            out_lp = torch.where(acc_k, lp_k, out_lp)
            accept = accept | acc_k
            in_dr = in_dr & ~acc_k
            past_alpha = torch.where(in_dr, torch.clamp(dr_alpha, 0.0, 1.0 - 1e-12), past_alpha)
        return out_c, out_i, out_ll, out_lp, accept.sum(dim=1)


__all__ = ["DistributionGenerateRJ", "DelayedRejectionRJ", "leaf_counts", "birth_death_slot",
           "combinatorics"]
