"""Batched tridiagonal solver (Thomas algorithm).

Counterpart of ``emri_frequencydomainwaveforms_tpu.ops.tridiag``. The solve
is sequential in the system size n (a Python loop over ~100-200 knots) and
vectorized over every leading batch axis (walkers x modes).
"""

from __future__ import annotations

import torch


def thomas_solve(
    dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve tridiagonal systems ``A x = b`` along the last axis.

    Args:
      dl: sub-diagonal ``(..., n)``, ``dl[..., 0]`` ignored.
      d: main diagonal ``(..., n)``.
      du: super-diagonal ``(..., n)``, ``du[..., -1]`` ignored.
      b: right-hand side ``(..., n)``.

    Returns:
      x of the broadcast shape ``(..., n)``.
    """
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    n = d.shape[-1]
    c_prev = torch.zeros_like(d[..., 0])
    g_prev = torch.zeros_like(d[..., 0])
    cs, gs = [], []
    # forward sweep: c'_i = du_i / (d_i - dl_i c'_{i-1}),
    #                g_i  = (b_i - dl_i g_{i-1}) / (d_i - dl_i c'_{i-1})
    for i in range(n):
        denom = d[..., i] - dl[..., i] * c_prev
        c_prev = du[..., i] / denom
        g_prev = (b[..., i] - dl[..., i] * g_prev) / denom
        cs.append(c_prev)
        gs.append(g_prev)
    # back substitution: x_i = g_i - c'_i x_{i+1}
    x_next = torch.zeros_like(d[..., 0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = gs[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


__all__ = ["thomas_solve"]
