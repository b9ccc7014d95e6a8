"""Batched cubic splines (natural and not-a-knot).

Counterpart of ``emri_frequencydomainwaveforms_tpu.ops.cubic_spline``. The
knots may carry leading batch axes (one trajectory per walker), which must
broadcast against the values' leading axes: fit ``y`` of shape
``(B, M, n)`` at knots ``x[:, None, :]`` of shape ``(B, 1, n)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from .tridiag import thomas_solve


class CubicSplineCoeffs(NamedTuple):
    """``y(t) = c0 + c1*dx + c2*dx^2 + c3*dx^3`` with ``dx = t - x[j]``.

    Attributes:
      x: knots ``(..., n)``.
      c: coefficients ``(..., n-1, 4)`` ordered ``(c0, c1, c2, c3)``.
    """

    x: torch.Tensor
    c: torch.Tensor


def fit_cubic_spline(x: torch.Tensor, y: torch.Tensor, bc: str = "natural") -> CubicSplineCoeffs:
    """Fit a (batch of) cubic spline(s) through ``(x, y)``.

    Solves for the knot slopes (Hermite form), which keeps both boundary
    conditions tridiagonal; see the JAX counterpart for the row algebra.
    ``bc`` is "natural" or "not-a-knot" (scipy-equivalent).
    """
    n = x.shape[-1]
    h = torch.diff(x, dim=-1)  # (..., n-1)
    slope = torch.diff(y, dim=-1) / h
    batch = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])

    # interior rows i = 1..n-2:
    #   h[i] s[i-1] + 2 (h[i-1] + h[i]) s[i] + h[i-1] s[i+1]
    #     = 3 (h[i] slope[i-1] + h[i-1] slope[i])
    dl_int = h[..., 1:]
    d_int = 2.0 * (h[..., :-1] + h[..., 1:])
    du_int = h[..., :-1]
    rhs_int = 3.0 * (h[..., 1:] * slope[..., :-1] + h[..., :-1] * slope[..., 1:])

    one = torch.ones_like(h[..., :1])
    zero = torch.zeros_like(h[..., :1])
    if bc == "natural":
        d0, du0 = 2.0 * one, one
        b0 = 3.0 * slope[..., 0:1]
        d_n, dl_n = 2.0 * one, one
        b_n = 3.0 * slope[..., -1:]
    elif bc == "not-a-knot":
        if n < 4:
            return fit_cubic_spline(x, y, bc="natural")
        h0, h1 = h[..., 0:1], h[..., 1:2]
        hm1, hm2 = h[..., -1:], h[..., -2:-1]
        x20 = h0 + h1
        xm20 = hm1 + hm2
        d0 = h1
        du0 = x20
        b0 = ((h0 + 2.0 * x20) * h1 * slope[..., 0:1] + h0**2 * slope[..., 1:2]) / x20
        d_n = hm2
        dl_n = xm20
        b_n = (hm1**2 * slope[..., -2:-1] + (2.0 * xm20 + hm1) * hm2 * slope[..., -1:]) / xm20
    else:
        raise ValueError(f"unknown bc {bc!r}")

    dl = torch.cat([zero, dl_int, dl_n], dim=-1)
    d = torch.cat([d0, d_int, d_n], dim=-1)
    du = torch.cat([du0, du_int, zero], dim=-1)
    rhs = torch.cat(
        [b0.expand(batch + (1,)), rhs_int.expand(batch + (n - 2,)), b_n.expand(batch + (1,))],
        dim=-1,
    )
    s = thomas_solve(
        dl.expand(batch + (n,)), d.expand(batch + (n,)), du.expand(batch + (n,)), rhs
    )

    s_lo = s[..., :-1]
    s_hi = s[..., 1:]
    c0 = y[..., :-1].expand(batch + (n - 1,))
    c1 = s_lo
    c2 = (3.0 * slope - 2.0 * s_lo - s_hi) / h
    c3 = (s_lo + s_hi - 2.0 * slope) / h**2
    return CubicSplineCoeffs(x=x, c=torch.stack([c0, c1, c2, c3], dim=-1))


def _segment_index(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Index of the segment containing each query (clamped to valid range).

    ``x`` is ``(..., n)``, ``xq`` is ``(..., m)`` with the same leading axes
    (or ``x`` 1-D, shared by every query).
    """
    idx = torch.searchsorted(x.contiguous(), xq.contiguous(), right=True) - 1
    return idx.clamp(0, x.shape[-1] - 2)


def spline_eval(sp: CubicSplineCoeffs, xq: torch.Tensor, deriv: int = 0) -> torch.Tensor:
    """Evaluate the spline (or its 1st/2nd/3rd derivative) at ``xq``.

    ``sp.x`` is ``(n,)`` or ``(B, n)``; ``xq`` is ``(m,)`` or ``(B, m)``
    matching it; ``sp.c`` is ``(..., n-1, 4)`` with ``B`` as its first axis
    when the knots are batched. Returns ``sp.c.shape[:-2] + (m,)``.
    """
    j = _segment_index(sp.x, xq)
    dx = xq - torch.gather(sp.x, -1, j)
    c = sp.c
    extra = c.dim() - 2 - (j.dim() - 1)  # spline axes between batch and segment
    jj = j.reshape(j.shape[:-1] + (1,) * extra + j.shape[-1:])
    dx = dx.reshape(jj.shape)
    jj = jj.expand(c.shape[:-2] + j.shape[-1:])
    cj = torch.gather(c, -2, jj.unsqueeze(-1).expand(jj.shape + (4,)))
    c0, c1, c2, c3 = cj[..., 0], cj[..., 1], cj[..., 2], cj[..., 3]
    if deriv == 0:
        return c0 + dx * (c1 + dx * (c2 + dx * c3))
    if deriv == 1:
        return c1 + dx * (2.0 * c2 + 3.0 * dx * c3)
    if deriv == 2:
        return 2.0 * c2 + 6.0 * dx * c3
    if deriv == 3:
        return 6.0 * c3 + torch.zeros_like(dx)
    raise ValueError("deriv must be 0, 1, 2 or 3")


def spline_eval_at_segments(
    sp: CubicSplineCoeffs, j: torch.Tensor, xq: torch.Tensor, deriv: int = 0
) -> torch.Tensor:
    """Evaluate a batch of splines (``sp.x`` (B, n), ``sp.c`` (B, n-1, 4)) at
    ``xq`` (B, m) with precomputed segment indices ``j`` (B, m) (skips the
    search). Returns (B, m)."""
    dx = xq - torch.gather(sp.x, -1, j)
    cj = torch.gather(sp.c, -2, j.unsqueeze(-1).expand(j.shape + (4,)))
    c0, c1, c2, c3 = cj[..., 0], cj[..., 1], cj[..., 2], cj[..., 3]
    if deriv == 0:
        return c0 + dx * (c1 + dx * (c2 + dx * c3))
    if deriv == 1:
        return c1 + dx * (2.0 * c2 + 3.0 * dx * c3)
    return 2.0 * c2 + 6.0 * dx * c3


class CubicSplineInterpolant:
    """The reference engine's interpolant: built from ``(t, y)`` with ``y``
    of shape ``(ninterps, length)`` or ``(length,)``, called with new times
    for values of shape ``(ninterps, m)``. ``device``: where the spline
    lives (default a tensor argument's, else the current CUDA device)."""

    def __init__(self, t, y, bc: str = "natural", device=None):
        dev = resolve_device(device, t, y)
        t, y = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (t, y))
        self.coeffs = fit_cubic_spline(t, y, bc=bc)

    def __call__(self, t_new, deriv: int = 0):
        t_new = torch.as_tensor(t_new, dtype=torch.float64, device=self.coeffs.x.device)
        return spline_eval(self.coeffs, t_new, deriv=deriv)


__all__ = [
    "CubicSplineCoeffs",
    "fit_cubic_spline",
    "spline_eval",
    "spline_eval_at_segments",
    "CubicSplineInterpolant",
]
