"""Batched adaptive Dormand-Prince 5(4) inspiral integrator with dense knots.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.integrate``. The
reference runs one ``lax.while_loop`` per lane under ``vmap``; here one
Python loop advances the whole walker batch until no lane is active, and a
per-lane ``active`` mask freezes finished lanes exactly as the vmapped loop
does (a lane's whole carry, including its iteration count, stops changing
once its own loop condition is false). Accepted steps are written into a
fixed ``(B, max_steps)`` knot buffer; the tail past the live knots is padded
with a strictly increasing time ramp, constant (p, e) and curvature-matched
quadratic phases (see the reference for why), by `pad_knots`.

This loop is the plain version of the dp5 trajectory: on CUDA tensors
`ops.dp5_inspiral` runs each lane's loop in one kernel launch instead, with
the same knots, and pads them with `pad_knots` too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import tracing

# Dormand-Prince 5(4) tableau.
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


class InspiralKnots(NamedTuple):
    """Adaptive-step output of a batch of inspirals (static shapes)."""

    t: torch.Tensor  # (B, max_steps) geometric time, strictly increasing incl. pad
    y: torch.Tensor  # (B, max_steps, 4) state [p, e, Phi_phi, Phi_r]
    n: torch.Tensor  # (B,) int32 live knot count


def integrate_inspiral(
    rhs: Callable[[torch.Tensor], torch.Tensor],
    stop: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    t_max: torch.Tensor,
    *,
    max_steps: int = 512,
    rtol: float = 1e-11,
    atol: float = 1e-11,
    h0: float = 100.0,
    h_max_frac: float = 1.0 / 128.0,
    max_iters: int | None = None,
    tail_slope_mask: tuple | None = None,
) -> InspiralKnots:
    """Integrate ``dy/dt = rhs(y)`` per lane from t=0 until ``stop`` or ``t_max``.

    Args:
      rhs: (B, 4) state -> (B, 4) rate (autonomous, lanes independent).
      stop: (B, 4) state -> (B,) bool.
      y0: (B, 4) initial states; t_max: (B,) horizons in geometric time.
      tail_slope_mask: per-component 0/1; masked-1 components are padded
        with a quadratic matching value, rate and curvature at the last
        live knot, masked-0 components are padded constant.

    Returns:
      InspiralKnots; knot 0 is the initial condition.
    """
    if max_iters is None:
        max_iters = 4 * max_steps
    dtype, dev = y0.dtype, y0.device
    n_b, n_y = y0.shape
    lanes = torch.arange(n_b, device=dev)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=dtype, device=dev), (n_b,))

    t_buf = torch.zeros((n_b, max_steps), dtype=dtype, device=dev)
    y_buf = torch.zeros((n_b, max_steps, n_y), dtype=dtype, device=dev)
    y_buf[:, 0] = y0

    t = torch.zeros((n_b,), dtype=dtype, device=dev)
    y = y0.clone()
    h = torch.full((n_b,), h0, dtype=dtype, device=dev)
    k0 = rhs(y0)  # FSAL carry: rhs(y)
    count = torch.ones((n_b,), dtype=torch.int32, device=dev)  # knot 0 = IC
    # a lane whose rate is not finite at its initial state (below the
    # separatrix, e outside [0, 1)) can accept no step: it keeps its one
    # knot whether it is stopped now or after max_iters rejections, and
    # stopping it now keeps it from holding the whole batch in the loop
    done = ~torch.isfinite(k0).all(dim=-1)
    iters = torch.zeros((n_b,), dtype=torch.int32, device=dev)

    def one_step(y, h, k0):
        hh = h[:, None]
        k = [k0]
        for i in range(1, 7):
            yi = y
            for j, aij in enumerate(_A[i]):
                yi = yi + hh * aij * k[j]
            k.append(rhs(yi))
        y5 = y
        y4 = y
        for i in range(7):
            y5 = y5 + hh * _B5[i] * k[i]
            y4 = y4 + hh * _B4[i] * k[i]
        err = y5 - y4
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        err_norm = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
        err_norm = torch.where(torch.isnan(err_norm), torch.inf, err_norm)
        return y5, err_norm, k[6]

    trips = 0
    while True:
        active = (~done) & (iters < max_iters) & (count < max_steps)
        if not bool(active.any()):
            break
        trips += 1
        hs = torch.minimum(h, t_max - t)  # land exactly on t_max
        y_new, err_norm, k_last = one_step(y, hs, k0)
        accept = err_norm <= 1.0
        fac = torch.clamp(
            0.9 * torch.where(err_norm > 0, err_norm, torch.full_like(err_norm, 1e-16)) ** -0.2,
            0.2,
            5.0,
        )
        h_next = torch.minimum(
            torch.clamp_min(h * torch.where(accept, fac, torch.clamp_max(fac, 1.0)), 1e-6),
            t_max * h_max_frac,
        )
        t_new = t + hs
        hit_stop = stop(y_new)
        hit_tmax = t_new >= t_max * (1.0 - 1e-12)
        # a step crossing the stop surface is rejected and halved unless tiny
        tiny = hs <= torch.clamp_min(1e-9 * t_max, 1e-3)
        accept_final = accept & (~hit_stop | tiny) & active
        reject_for_stop = accept & hit_stop & ~tiny

        # per-lane knot write (the reference's one-hot select is a TPU
        # scatter workaround; an indexed write is the same update here)
        idx = torch.clamp_max(count, max_steps - 1).long()
        t_buf[lanes, idx] = torch.where(accept_final, t_new, t_buf[lanes, idx])
        y_buf[lanes, idx] = torch.where(accept_final[:, None], y_new, y_buf[lanes, idx])
        count = torch.where(accept_final, count + 1, count)

        done = done | (accept_final & (hit_stop | hit_tmax))
        h = torch.where(active, torch.where(reject_for_stop, hs * 0.5, h_next), h)
        # only accepted steps adopt the (finite by construction) last stage
        k0 = torch.where(accept_final[:, None], k_last, k0)
        t = torch.where(accept_final, t_new, t)
        y = torch.where(accept_final[:, None], y_new, y)
        iters = torch.where(active, iters + 1, iters)

    if tracing.active():
        # a lane slot of a trip is an accepted step, a rejected one, or a
        # finished lane waiting for the slowest
        accepted = int(count.sum()) - n_b
        tracing.count("dp5.trips", trips)
        tracing.count("dp5.lane_slots", n_b * trips)
        tracing.count("dp5.accepted", accepted)
        tracing.count("dp5.rejected", int(iters.sum()) - accepted)
    slopes = None
    if tail_slope_mask is not None:
        mask = torch.as_tensor(tail_slope_mask, dtype=dtype, device=dev)

        def slopes(last_y):
            rates_full, acc_full = torch.func.jvp(rhs, (last_y,), (rhs(last_y),))
            # at the separatrix edge the RHS derivative can leave the bound-orbit
            # domain: fall back to linear continuation there
            acc_full = torch.where(torch.isfinite(acc_full), acc_full, torch.zeros_like(acc_full))
            return rates_full * mask, acc_full * mask

    return pad_knots(t_buf, y_buf, count, slopes)


def pad_knots(
    t_buf: torch.Tensor,
    y_buf: torch.Tensor,
    n: torch.Tensor,
    slopes: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> InspiralKnots:
    """The knots past each lane's ``n`` live ones (whatever ``t_buf`` (B,
    max_steps) and ``y_buf`` (B, max_steps, D) hold there): a strictly
    increasing time ramp, and the quadratic of value, rate and curvature at
    the last live knot, ``slopes(last_y) -> (rates, acc)`` each (B, D) (a
    component with zero rate and curvature stays constant); no ``slopes``:
    the last live state."""
    dtype, dev = t_buf.dtype, t_buf.device
    n_b, max_steps = t_buf.shape
    lanes = torch.arange(n_b, device=dev)
    n_l = (n - 1).clamp_min(0).long()
    idxs = torch.arange(max_steps, device=dev)
    last_t = t_buf[lanes, n_l]
    last_y = y_buf[lanes, n_l]
    pad_dt = torch.clamp_min(last_t / torch.clamp_min(n.to(dtype), 1.0), 1.0)
    t_pad = last_t[:, None] + pad_dt[:, None] * (idxs[None, :] - (n[:, None] - 1)).to(dtype)
    live = idxs[None, :] < n[:, None]
    t_out = torch.where(live, t_buf, t_pad)
    if slopes is not None:
        rates, acc = slopes(last_y)
        dt_pad = (t_pad - last_t[:, None])[:, :, None]
        y_pad = last_y[:, None, :] + rates[:, None, :] * dt_pad + 0.5 * acc[:, None, :] * dt_pad**2
    else:
        y_pad = last_y[:, None, :].expand_as(y_buf)
    y_out = torch.where(live[:, :, None], y_buf, y_pad)
    return InspiralKnots(t=t_out, y=y_out, n=n)


__all__ = ["InspiralKnots", "integrate_inspiral", "pad_knots"]
