"""Bicubic interpolation on regular 2-D grids (batched).

Counterpart of ``emri_frequencydomainwaveforms_tpu.ops.interp2d``:
Catmull-Rom bicubic patches over local 4x4 stencils (C^1, no global solves).
`interp2d_bicubic` gathers the stencil, the natural form on a GPU;
`interp2d_bicubic_dense` evaluates the same surface as two dense
contractions against cardinal weight vectors (kept because
``multipole_flux_e_l(dense=True)`` offers it). Both run in the dtype of
``values`` (float64 for the flux grid).
"""

from __future__ import annotations

import torch


def _cr_weights(t):
    """Catmull-Rom basis weights for the 4-point stencil at parameter t."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _stencil(x0, dx, y0, dy, values, xq, yq):
    """Clamped stencil origin (ix, iy) and in-cell parameters (tx, ty)."""
    nx, ny = values.shape[0], values.shape[1]
    xq, yq = torch.broadcast_tensors(
        torch.as_tensor(xq, dtype=values.dtype, device=values.device),
        torch.as_tensor(yq, dtype=values.dtype, device=values.device),
    )
    fx = (xq - x0) / dx
    fy = (yq - y0) / dy
    # floor carries no derivative, so the indices are taken from detached
    # values (forward-mode differentiation runs through tx, ty only)
    ix = torch.floor(fx.detach()).long().clamp(1, nx - 3)
    iy = torch.floor(fy.detach()).long().clamp(1, ny - 3)
    tx = torch.clamp(fx - ix, -1.0, 2.0)
    ty = torch.clamp(fy - iy, -1.0, 2.0)
    return ix, iy, tx, ty


def interp2d_bicubic(x0: float, dx: float, y0: float, dy: float,
                     values: torch.Tensor, xq, yq) -> torch.Tensor:
    """Catmull-Rom bicubic interpolation of ``values`` (nx, ny, ...) at (xq, yq).

    The grid is uniform: ``x_i = x0 + i dx``, ``y_j = y0 + j dy``. Queries
    are clamped to the valid interior. Trailing dims of ``values`` ride
    along; output shape = broadcast(xq, yq).shape + values.shape[2:].
    """
    ix, iy, tx, ty = _stencil(x0, dx, y0, dy, values, xq, yq)
    wx = _cr_weights(tx)
    wy = _cr_weights(ty)
    extra = (1,) * (values.dim() - 2)
    out = 0.0
    for a in range(4):
        row = 0.0
        for b in range(4):
            v = values[ix + (a - 1), iy + (b - 1)]
            row = row + wy[b].reshape(wy[b].shape + extra) * v
        out = out + wx[a].reshape(wx[a].shape + extra) * row
    return out


def interp2d_bicubic_dense(x0: float, dx: float, y0: float, dy: float,
                           values: torch.Tensor, xq, yq) -> torch.Tensor:
    """Gather-free evaluation of the same Catmull-Rom bicubic surface.

    The 4-point stencil weights are scattered into dense cardinal weight
    vectors over the full grid axes and contracted against the table (y
    inner, then x): the stencil sum up to reduction order. Non-finite grid
    entries are set to 0 first, since the contraction multiplies zero
    weights against the whole table.
    """
    nx, ny = values.shape[0], values.shape[1]
    dev, dt = values.device, values.dtype
    ix, iy, tx, ty = _stencil(x0, dx, y0, dy, values, xq, yq)
    wx = torch.stack(_cr_weights(tx), dim=-1)  # (..., 4)
    wy = torch.stack(_cr_weights(ty), dim=-1)
    offs = torch.arange(-1, 3, device=dev)
    selx = (ix[..., None] + offs)[..., :, None] == torch.arange(nx, device=dev)  # (..., 4, nx)
    sely = (iy[..., None] + offs)[..., :, None] == torch.arange(ny, device=dev)
    wvx = torch.sum(selx.to(dt) * wx[..., :, None], dim=-2)
    wvy = torch.sum(sely.to(dt) * wy[..., :, None], dim=-2)

    values = torch.where(torch.isfinite(values), values, torch.zeros((), dtype=dt, device=dev))
    vflat = values.reshape(nx, ny, -1)
    # elementwise multiply-and-sum, never a matmul: the result must not
    # depend on the process-wide TF32 switches
    tmp = torch.sum(wvy[..., None, :, None] * vflat, dim=-2)  # (..., nx, C)
    out = torch.sum(wvx[..., :, None] * tmp, dim=-2)  # (..., C)
    return out.reshape(out.shape[:-1] + values.shape[2:])


__all__ = ["interp2d_bicubic", "interp2d_bicubic_dense"]
