"""Multiple-try Metropolis with independent distribution draws.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.moves.mt
.MTDistGenMove``: per walker, ``num_try`` candidates from a fixed
distribution q, each weighted by the tempered posterior over q; one is
selected with probability proportional to its weight (Gumbel-max over the
log weights) and accepted with the multiple-try ratio

  alpha = sum_j w(y_j) / ( sum_{j != I} w(y_j) + w(x) ),

the reverse cloud being the forward draws with the current point in place
of the selected candidate. All (ntemps, nwalkers, num_try) candidates go
into one likelihood call (the likelihood chunks it by its ``subset``).

`MTDistGenMoveRJ` is the reversible-jump form over the tree contract
(`moves.tree`): every walker proposes a birth or a death of one leaf, both
weighed as a birth against the reduced state (the walker without the leaf
in question): ``num_try`` candidate leaves from q, weights ``log w_j =
beta ll_j + lp_j - log q_j - lp_red``, one chosen by Gumbel-max on
``-log(-log u)`` (a death puts the real leaf at try 0 and chooses it), and
the estimator ``logsumexp(log w) - beta ll_red - log J``, added for a
birth and subtracted for a death, beside the slot-choice combinatorics of
`moves.rj`. Non-finite weights become -inf. Branches are updated in turn.
"""

from __future__ import annotations

import math

import torch

from .distgen import ppf_draw
from .rj import birth_death_slot, branch_functions, branch_value, combinatorics, leaf_counts
from .stretch import Move, _uniform, evaluate


class MTDistGenMove(Move):
    """Independent multiple-try Metropolis from a `ProbDistContainer`.

    Draws: the candidates' unit-cube points (ntemps, nwalkers, num_try,
    ndim), the selection uniforms (ntemps, nwalkers, num_try) and the accept
    uniforms (ntemps, nwalkers), in that order.
    """

    def __init__(self, generate_dist, num_try: int = 10, independent: bool = True,
                 rj: bool = False, **kwargs):
        del kwargs
        if not independent:
            raise NotImplementedError("only independent proposal MT is implemented")
        self.dist = generate_dist
        self.num_try = int(num_try)
        self.rj = rj

    def draws(self, generator, shape):
        ntemps, nwalkers, ndim = shape
        j = self.num_try
        return (_uniform(generator, (ntemps, nwalkers, j, ndim)),
                _uniform(generator, (ntemps, nwalkers, j)), _uniform(generator, (ntemps, nwalkers)))

    def step(self, coords, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        ntemps, nwalkers, ndim = coords.shape
        u_draw, u_sel, u = draws
        cands = ppf_draw(self.dist, u_draw)
        logq = self.dist.logpdf(cands)
        lp_c, ll_c = evaluate(cands, logp_fn, logl_fn)

        # log importance weights: the tempered posterior over the draw density
        logw = betas[:, None, None] * ll_c + lp_c - logq
        logw = torch.where(torch.isfinite(logw), logw, -torch.inf)

        # Gumbel-max selection ~ categorical(softmax(logw))
        sel = torch.argmax(logw - torch.log(-torch.log(u_sel)), dim=-1)
        y = torch.gather(cands, 2, sel[..., None, None].expand(-1, -1, 1, ndim))[:, :, 0]
        ll_y = torch.gather(ll_c, 2, sel[..., None])[..., 0]
        lp_y = torch.gather(lp_c, 2, sel[..., None])[..., 0]

        # the current point's weight under the same scheme
        logw_x = betas[:, None] * log_like + log_prior - self.dist.logpdf(coords)
        logw_x = torch.where(torch.isfinite(logw_x), logw_x, -torch.inf)
        num = torch.logsumexp(logw, dim=-1)
        # the denominator: the forward cloud with x in place of the selected draw
        chosen = torch.arange(self.num_try)[None, None, :] == sel[..., None]
        den = torch.logaddexp(torch.logsumexp(logw.masked_fill(chosen, -torch.inf), dim=-1),
                              logw_x)

        accept = (torch.log(u) < num - den) & torch.isfinite(lp_y)
        return (torch.where(accept[..., None], y, coords), torch.where(accept, ll_y, log_like),
                torch.where(accept, lp_y, log_prior), accept.sum(dim=1))


class MTDistGenMoveRJ:
    """Reversible-jump multiple-try with independent distribution draws.

    ``generate_dist``: a `ProbDistContainer` or a dict of them per branch;
    ``nleaves_min`` / ``nleaves_max``: ints or dicts per branch. Candidates
    come from each parameter's ``ppf`` of unit-cube points.
    """

    def __init__(self, generate_dist, num_try: int = 10, nleaves_min=0, nleaves_max=1,
                 **kwargs):
        del kwargs
        self.dist = generate_dist
        self.num_try = int(num_try)
        self.nleaves_min = nleaves_min
        self.nleaves_max = nleaves_max

    def _cand_draws(self, generator, shape):
        """The draws the candidates (T, W, J, D) are made of: unit-cube
        points."""
        return _uniform(generator, shape)

    def _candidates(self, dist, draw):
        return ppf_draw(dist, draw)

    def _draw(self, dist, generator, shape):
        """Candidates of ``shape`` (T, W, J, D) from ``generator``."""
        return self._candidates(dist, self._cand_draws(generator, shape))

    def branch_draws(self, generator, shape):
        """For one branch's coords ``shape`` (T, W, L, D): the birth-or-death
        uniforms (T, W), the slot uniforms (T, W, L), the candidates' draws
        (T, W, J, D), the selection uniforms (T, W, J) and the accept
        uniforms (T, W), drawn in that order."""
        t, w, nl, d = shape
        j = self.num_try
        return (_uniform(generator, (t, w)), _uniform(generator, (t, w, nl)),
                self._cand_draws(generator, (t, w, j, d)), _uniform(generator, (t, w, j)),
                _uniform(generator, (t, w)))

    def draws(self, generator, coords: dict):
        """`branch_draws` of every branch, in branch order."""
        return [self.branch_draws(generator, tuple(c.shape)) for c in coords.values()]

    def propose_tree(self, generator, coords: dict, inds: dict, log_like, log_prior, betas,
                     logp_fn, logl_fn):
        """The tree contract: (coords, inds, log_like, log_prior, accepted
        per temperature, summed over the branches)."""
        return self.step_tree(coords, inds, log_like, log_prior, betas,
                              self.draws(generator, coords), logp_fn, logl_fn)

    def step_tree(self, coords, inds, log_like, log_prior, betas, draws, logp_fn, logl_fn):
        dists = self.dist if isinstance(self.dist, dict) else {name: self.dist for name in coords}
        coords, inds = dict(coords), dict(inds)
        n_total = None
        for name, draw in zip(list(coords), draws):
            loglike, logprior = branch_functions(coords, inds, name, logp_fn, logl_fn)
            coords[name], inds[name], log_like, log_prior, n_acc = self._step_branch(
                dists[name], branch_value(self.nleaves_min, name),
                branch_value(self.nleaves_max, name), coords[name], inds[name], log_like,
                log_prior, betas, draw, loglike, logprior)
            n_total = n_acc if n_total is None else n_total + n_acc
        return coords, inds, log_like, log_prior, n_total

    def _step_branch(self, dist, nleaves_min, nleaves_max, coords, inds, log_like, log_prior,
                     betas, draws, loglike, logprior):
        t, w, nl, d = coords.shape
        j = self.num_try
        u_bd, u_slot, cand_draw, u_sel, u = draws
        n_active, can_birth, can_death = leaf_counts(inds, nleaves_min, nleaves_max)
        do_birth = torch.where(can_birth & can_death, u_bd < 0.5, can_birth)
        onehot, slot = birth_death_slot(inds, do_birth, u_slot)
        legal = torch.where(do_birth, can_birth, can_death)

        # the reduced state: the walker without the leaf in question
        inds_red = torch.where(do_birth[..., None], inds, inds & ~onehot)
        ll_red = loglike(coords, inds_red, legal)
        lp_red = logprior(coords, inds_red)

        # the candidate cloud; a death's real leaf at try 0
        cand = self._candidates(dist, cand_draw)
        cur_leaf = torch.gather(coords, 2, slot[..., None, None].expand(-1, -1, 1, d))
        is_fill = (~do_birth)[..., None, None] & (torch.arange(j)[None, None, :, None] == 0)
        cand = torch.where(is_fill, cur_leaf, cand)
        logq = dist.logpdf(cand)

        # the cloud folded into the walker axis, one call
        inds_new = inds_red | onehot
        coords_j = torch.where(onehot[:, :, None, :, None], cand[:, :, :, None, :],
                               coords[:, :, None].expand(t, w, j, nl, d))
        coords_j = coords_j.reshape(t, w * j, nl, d)
        inds_j = inds_new[:, :, None].expand(t, w, j, nl).reshape(t, w * j, nl)
        lp_j = logprior(coords_j, inds_j).reshape(t, w, j)
        need = legal[..., None] & torch.isfinite(lp_j)
        ll_j = loglike(coords_j, inds_j, need.reshape(t, w * j)).reshape(t, w, j)

        logw = betas[:, None, None] * ll_j + lp_j - logq - lp_red[..., None]
        logw = torch.where(torch.isfinite(logw), logw, -torch.inf)

        # Gumbel-max for a birth (argmax in greedy search mode), try 0 for a death
        g = -torch.log(-torch.log(u_sel))
        if getattr(self, "_greedy_select", False):
            g = torch.zeros_like(g)
        sel = torch.where(do_birth, torch.argmax(logw + g, dim=-1), 0)
        y = torch.gather(cand, 2, sel[..., None, None].expand(-1, -1, 1, d))[:, :, 0]
        ll_sel = torch.gather(ll_j, 2, sel[..., None])[..., 0]
        lp_sel = torch.gather(lp_j, 2, sel[..., None])[..., 0]

        core = torch.logsumexp(logw, dim=-1) - betas[:, None] * ll_red - math.log(j)
        comb_birth, comb_death = combinatorics(n_active, nl)
        lnpdiff = torch.where(do_birth, comb_birth + core, comb_death - core)
        accept = ((torch.log(u) < lnpdiff) & legal
                  & torch.where(do_birth, torch.isfinite(lp_sel), True))

        acc_birth, acc_death = accept & do_birth, accept & ~do_birth
        coords = torch.where((acc_birth[..., None] & onehot)[..., None], y[..., None, :], coords)
        inds = torch.where(acc_birth[..., None], inds | onehot,
                           torch.where(acc_death[..., None], inds & ~onehot, inds))
        log_like = torch.where(acc_birth, ll_sel, torch.where(acc_death, ll_red, log_like))
        log_prior = torch.where(acc_birth, lp_sel, torch.where(acc_death, lp_red, log_prior))
        return coords, inds, log_like, log_prior, accept.sum(dim=1)


__all__ = ["MTDistGenMove", "MTDistGenMoveRJ"]
