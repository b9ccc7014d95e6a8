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
"""

from __future__ import annotations

import torch

from .distgen import ppf_draw
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


__all__ = ["MTDistGenMove"]
