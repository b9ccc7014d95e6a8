"""Frequency-domain stationary-phase mode summation.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.summation_fd``
(`FDKernelInputs`, `prepare_fd_inputs`, the general sorted-grid kernel
`fd_mode_sum`, the banded uniform-grid kernel `fd_mode_sum_uniform`, both
with the turnover and negative extra slots, `_polar_envelope`,
`_level1_uniform_tables`, and the Pallas-named entry points
`fd_mode_sum_uniform_pallas[_batched]`); the module docstring there carries the
mathematics. Every function takes a leading walker-batch axis B.

The banded kernel has two levels, as in the reference:

* **Level 1** (`_level1_uniform_tables`, float64 phase path, float32
  envelope): per window node, a segment lookup, 3 Newton steps on
  Phi'(t) = 2 pi f, the K_{1/3} SPA factor and the polar envelope, folded
  into per-run Hermite / Catmull-Rom coefficients with the exact
  integer-cycle split of the phase.
* **Level 2** (the dense pass): `ops.fd_dense.fd_dense_accumulate`, the
  hand-written CUDA kernel on the GPU, its plain version on the CPU.

The reference assigns nodes to trajectory segments with a one-hot compare
matrix contracted on the TPU's matrix unit, carrying float64 table entries
as (hi, lo) float32 pairs. Here the segment index comes from
``torch.searchsorted`` over the same float32 boundaries (the same count the
compare matrix takes), followed by a gather; the gathered values are rounded
through the same (hi, lo) float32 split, so the dense pass receives the
reference's tables to float32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.bessel import kve_one_third_imag
from ..ops.cubic_spline import fit_cubic_spline, spline_eval
from ..ops.fd_dense import DenseGroup, fd_dense_accumulate
from ..ops.row_ops import row_cumsum
from .amplitude import ModeTable
from .modeselect import SelectedModes, top_k_stable

_TWO_PI = 2.0 * math.pi
_INT32_MAX = 2**31 - 1


def _f32(x: float) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


class FDKernelInputs(NamedTuple):
    """Shared trajectory splines + per-slot data, leading walker axis B.

    Field meanings as in the reference; shapes: t_knots (B, K); c_phi_phi,
    c_phi_r (B, K-1, 4); f_phi_knots, f_r_knots (B, K); ar_c, ai_c
    (B, k, K-1, 4); every per-slot field (B, k); n_live (B,).
    """

    t_knots: torch.Tensor
    c_phi_phi: torch.Tensor
    c_phi_r: torch.Tensor
    f_phi_knots: torch.Tensor
    f_r_knots: torch.Tensor
    ar_c: torch.Tensor
    ai_c: torch.Tensor
    m_sel: torch.Tensor
    n_sel: torch.Tensor
    w1_re: torch.Tensor
    w1_im: torch.Tensor
    w2_re: torch.Tensor
    w2_im: torch.Tensor
    mode_live: torch.Tensor
    n_live: torch.Tensor
    n_eff: torch.Tensor
    inc_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_live: torch.Tensor
    dec_lo: torch.Tensor
    dec_hi: torch.Tensor
    dec_live: torch.Tensor
    power: torch.Tensor
    neg_lo: torch.Tensor
    neg_hi: torch.Tensor
    neg_live: torch.Tensor
    w1n_re: torch.Tensor
    w1n_im: torch.Tensor
    w2n_re: torch.Tensor
    w2n_im: torch.Tensor


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA's conversion semantics (NaN -> 0, saturating)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2.0**31 - 1)
    return x.to(torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane ``jnp.take(x, idx, axis=1)``: x (B, M, ...), idx (B, k)."""
    idx = idx.long()
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def prepare_fd_inputs(
    t_knots: torch.Tensor,
    n_live: torch.Tensor,
    phi_phi_knots: torch.Tensor,
    phi_r_knots: torch.Tensor,
    a_re_knots: torch.Tensor,  # (B, K, M)
    a_im_knots: torch.Tensor,
    table: ModeTable,
    sel: SelectedModes,
    w1: tuple[torch.Tensor, torch.Tensor],  # per-candidate weights (B, M)
    w2: tuple[torch.Tensor, torch.Tensor],
    w1n: tuple[torch.Tensor, torch.Tensor] | None = None,
    w2n: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> FDKernelInputs:
    """Fit shared splines and compact per-slot arrays for the FD kernels."""
    dev, dt = t_knots.device, t_knots.dtype
    # not-a-knot phases: a natural end would force a zero chirp rate at t=0
    sp_pp = fit_cubic_spline(t_knots, phi_phi_knots, bc="not-a-knot")
    sp_pr = fit_cubic_spline(t_knots, phi_r_knots, bc="not-a-knot")
    # gather the selected modes before fitting (k of M candidates)
    a_re_sel = _take(a_re_knots.transpose(1, 2), sel.idx)  # (B, k, K)
    a_im_sel = _take(a_im_knots.transpose(1, 2), sel.idx)
    sp_ar = fit_cubic_spline(t_knots[:, None, :], a_re_sel, bc="not-a-knot")
    sp_ai = fit_cubic_spline(t_knots[:, None, :], a_im_sel, bc="not-a-knot")

    # knot frequencies from the phase-spline derivative (exact consistency)
    f_phi_knots = spline_eval(sp_pp, t_knots, deriv=1) / _TWO_PI
    f_r_knots = spline_eval(sp_pr, t_knots, deriv=1) / _TWO_PI

    m_arr = torch.as_tensor(table.ms.astype(np.float64), dtype=dt, device=dev)
    n_arr = torch.as_tensor(table.ns.astype(np.float64), dtype=dt, device=dev)
    m_sel = m_arr[sel.idx.long()]
    n_sel = n_arr[sel.idx.long()]

    # per-mode usable band: truncated at the first non-monotone live segment
    k = t_knots.shape[-1]
    f_knots_all = m_sel[..., None] * f_phi_knots[:, None, :] + n_sel[..., None] * f_r_knots[:, None, :]
    seg_idx = torch.arange(k - 1, device=dev)
    live_seg = seg_idx[None, None, :] < (n_live.long() - 1)[:, None, None]
    df = torch.diff(f_knots_all, dim=-1)
    bad = (df <= 0.0) & live_seg
    any_bad = bad.any(dim=-1)
    first_bad = torch.argmax(bad.to(torch.int32), dim=-1)
    n_eff = torch.where(any_bad, first_bad + 1, n_live.long()[:, None]).to(torch.int32)
    positive = f_knots_all[..., 0] > 0.0
    enough = n_eff >= 4
    mode_live = sel.mask * (positive & enough).to(dt)

    def first_run(ok):
        any_ok = ok.any(dim=-1)
        start = torch.argmax(ok.to(torch.int32), dim=-1)
        stop_mask = (~ok) & (seg_idx >= start[..., None])
        stop = torch.where(
            stop_mask.any(dim=-1), torch.argmax(stop_mask.to(torch.int32), dim=-1), k - 1
        )
        ok_len = any_ok & ((stop - start) >= 3)
        return start.to(torch.int32), stop.to(torch.int32), ok_len

    # increasing / decreasing runs restricted to f > 0 (partner-term branch)
    pos_seg = (f_knots_all[..., :-1] > 0.0) & (f_knots_all[..., 1:] > 0.0)
    inc_lo, inc_hi, inc_ok = first_run((df > 0.0) & live_seg & pos_seg)
    dec_lo, dec_hi, dec_ok = first_run((df < 0.0) & live_seg & pos_seg)
    inc_live = sel.mask * inc_ok.to(dt)
    dec_live = sel.mask * dec_ok.to(dt)
    # negative-frequency branch: increasing runs of g = -f where g > 0
    neg_seg = (f_knots_all[..., :-1] < 0.0) & (f_knots_all[..., 1:] < 0.0)
    neg_lo, neg_hi, neg_ok = first_run((df < 0.0) & live_seg & neg_seg)
    neg_live = sel.mask * neg_ok.to(dt)

    def take_w(w):
        return torch.gather(w, 1, sel.idx.long()) if w is not None else torch.zeros_like(m_sel)

    return FDKernelInputs(
        t_knots=t_knots,
        c_phi_phi=sp_pp.c,
        c_phi_r=sp_pr.c,
        f_phi_knots=f_phi_knots,
        f_r_knots=f_r_knots,
        ar_c=sp_ar.c,
        ai_c=sp_ai.c,
        m_sel=m_sel,
        n_sel=n_sel,
        w1_re=take_w(w1[0]),
        w1_im=take_w(w1[1]),
        w2_re=take_w(w2[0]),
        w2_im=take_w(w2[1]),
        mode_live=mode_live,
        n_live=n_live,
        n_eff=n_eff,
        inc_lo=inc_lo,
        inc_hi=inc_hi,
        inc_live=inc_live,
        dec_lo=dec_lo,
        dec_hi=dec_hi,
        dec_live=dec_live,
        power=sel.power,
        neg_lo=neg_lo,
        neg_hi=neg_hi,
        neg_live=neg_live if w1n is not None else torch.zeros_like(neg_live),
        w1n_re=take_w(w1n[0] if w1n is not None else None),
        w1n_im=take_w(w1n[1] if w1n is not None else None),
        w2n_re=take_w(w2n[0] if w2n is not None else None),
        w2n_im=take_w(w2n[1] if w2n is not None else None),
    )


def fd_mode_sum(
    inp: FDKernelInputs,
    f_pos: torch.Tensor,
    nodes_per_segment: int = 32,
    turnover_slots: int = 0,
    negative_slots: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """General sorted-grid FD summation: sum_i C_i(f) W1_i and W2_i on any
    ascending positive grid ``f_pos`` (nf,), shared by the batch.

    The independent check of the banded kernel. Level 1 places
    ``nodes_per_segment`` nodes uniformly in t inside each trajectory spline
    segment, where f = Phi'/(2 pi), Psi = Phi - 2 pi f t and dPsi/df =
    -2 pi t are closed forms (no root-finding), and builds per f-interval a
    cubic Hermite of Psi and a linear polar envelope. Level 2 locates each
    bin's interval, evaluates the Hermite in float64 (its coefficients reach
    hundreds of radians), reduces mod 2 pi and finishes (sin/cos, envelope,
    accumulation) in float32. Slots run one after the other over the whole
    batch: the main (increasing) slots, then ``turnover_slots`` decreasing
    branches and ``negative_slots`` negative-frequency branches picked per
    lane by power, exactly as in `fd_mode_sum_uniform`.

    Returns (o1_re, o1_im, o2_re, o2_im), each (B, nf), in ``f_pos``'s dtype.
    """
    t_knots = inp.t_knots
    dev, dt64 = t_knots.device, t_knots.dtype
    f32 = torch.float32
    n_b, k = t_knots.shape
    s_nodes = nodes_per_segment
    n_nodes = (k - 1) * s_nodes
    f_pos = torch.as_tensor(f_pos, device=dev)
    nf = f_pos.shape[-1]

    # static node layout: segment index + fractional position per node
    seg_of_node = torch.arange(k - 1, device=dev).repeat_interleave(s_nodes)
    frac_of_node = (torch.arange(s_nodes, dtype=dt64, device=dev) / s_nodes).repeat(k - 1)
    h_all = torch.diff(t_knots, dim=-1)  # (B, K-1)
    dx_node = frac_of_node * h_all[:, seg_of_node]  # (B, N)
    t_node = t_knots[:, seg_of_node] + dx_node
    node_idx = torch.arange(n_nodes, device=dev)
    f_grid = f_pos.expand(n_b, nf).contiguous()

    cphi_all = (
        inp.m_sel[..., None, None] * inp.c_phi_phi[:, None]
        + inp.n_sel[..., None, None] * inp.c_phi_r[:, None]
    )  # (B, k, K-1, 4)
    k_max = cphi_all.shape[1]

    def ones(n):
        return torch.ones((n_b, n), dtype=torch.int32, device=dev)

    def pick_of(live, n_slots):
        return top_k_stable(live * (inp.power + 1e-300), min(n_slots, k_max))[1]

    # slot fields: cphi, ar, ai, w1r, w1i, w2r, w2i, live, k_lo, k_hi, dirn
    slots = [[cphi_all, inp.ar_c, inp.ai_c, inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im,
              inp.inc_live, inp.inc_lo, inp.inc_hi, ones(k_max)]]
    if turnover_slots > 0:
        pick = pick_of(inp.dec_live, turnover_slots)
        slots.append(
            [_take(x, pick) for x in (cphi_all, inp.ar_c, inp.ai_c, inp.w1_re, inp.w1_im,
                                      inp.w2_re, inp.w2_im, inp.dec_live, inp.dec_lo, inp.dec_hi)]
            + [-ones(pick.shape[1])]
        )
    if negative_slots > 0:
        pick_n = pick_of(inp.neg_live, negative_slots)
        # U = -Phi: negated phase coefficients, A in place of conj(A), the
        # neg weight pairs; g = -f increases
        slots.append(
            [-_take(cphi_all, pick_n), _take(inp.ar_c, pick_n), -_take(inp.ai_c, pick_n)]
            + [_take(x, pick_n) for x in (inp.w1n_re, inp.w1n_im, inp.w2n_re, inp.w2n_im,
                                          inp.neg_live, inp.neg_lo, inp.neg_hi)]
            + [ones(pick_n.shape[1])]
        )
    fields = [torch.cat([grp[i] for grp in slots], dim=1) for i in range(11)]

    def at(x, idx):  # per-lane x[idx] along the node axis
        return torch.gather(x, 1, idx)

    out = [torch.zeros((n_b, nf), dtype=f32, device=dev) for _ in range(4)]
    for s in range(fields[0].shape[1]):
        cphi_m, ar_ci, ai_ci, w1r, w1i, w2r, w2i, live_i, k_lo_i, k_hi_i, dirn_i = (
            x[:, s] for x in fields
        )

        # ===== Level 1: per-node closed-form evaluation (float64) =====
        cn = cphi_m[:, seg_of_node]  # (B, N, 4)
        c0, c1, c2, c3 = cn[..., 0], cn[..., 1], cn[..., 2], cn[..., 3]
        dxn = dx_node
        f_n = (c1 + dxn * (2.0 * c2 + 3.0 * c3 * dxn)) / _TWO_PI
        phi_n = c0 + dxn * (c1 + dxn * (c2 + dxn * c3))
        psi_n = phi_n - _TWO_PI * f_n * t_node
        fdot_n = (2.0 * c2 + 6.0 * c3 * dxn) / _TWO_PI
        fddot_n = (6.0 * c3) / _TWO_PI

        dxn32 = dxn.to(f32)
        arn = ar_ci[:, seg_of_node].to(f32)
        ain = ai_ci[:, seg_of_node].to(f32)
        a_re = arn[..., 0] + dxn32 * (arn[..., 1] + dxn32 * (arn[..., 2] + dxn32 * arn[..., 3]))
        a_im = ain[..., 0] + dxn32 * (ain[..., 1] + dxn32 * (ain[..., 2] + dxn32 * ain[..., 3]))

        # uniform SPA factor in the overflow-free float32 form (w formed in
        # float64: fdot^3 underflows float32); on a decreasing branch the
        # factor is the complex conjugate
        fdot_s = torch.clamp_min(torch.abs(fdot_n), 1e-300)
        w_arg = -_TWO_PI * fdot_s**3 / (3.0 * torch.clamp_min(fddot_n * fddot_n, 1e-300))
        w32 = torch.clamp(w_arg, -1e12, -1e-30).to(f32)
        k_re, k_im = kve_one_third_imag(w32)
        k_im = k_im * dirn_i[:, None].to(f32)
        corr = torch.sqrt(2.0 * torch.abs(w32) * _f32(1.0 / math.pi))
        inv_sqrt_fdot = torch.rsqrt(torch.clamp_min(fdot_s.to(f32), _f32(1e-37)))
        cr = k_re * corr * inv_sqrt_fdot
        ci = k_im * corr * inv_sqrt_fdot
        # envelope E = conj(A) * F  (float32)
        e_re = a_re * cr + a_im * ci
        e_im = a_re * ci - a_im * cr

        # node order must ascend in f: a decreasing branch is traversed in
        # reverse time
        rev = dirn_i < 0

        def orient(x):
            return torch.where(rev[:, None], torch.flip(x, dims=(-1,)), x)

        f_n = orient(f_n)
        psi_n = orient(psi_n)
        t_node_o = orient(t_node)
        e_re = orient(e_re)
        e_im = orient(e_im)

        # knot window -> node window (in oriented index space)
        lo_n = k_lo_i.long() * s_nodes
        hi_n = k_hi_i.long() * s_nodes
        lo_o = torch.where(rev, (n_nodes - 1) - hi_n, lo_n)
        hi_o = torch.where(rev, (n_nodes - 1) - lo_n, hi_n)

        # strictly increasing node frequencies: true values inside the
        # window (its edge nodes included), linear ramps outside, whose
        # intervals' bins are masked by in_range
        f_lo_val = at(f_n, lo_o.clamp(0, n_nodes - 1)[:, None])
        f_hi_val = at(f_n, hi_o.clamp(0, n_nodes - 1)[:, None])
        step = torch.clamp_min(torch.abs(f_hi_val), 1.0)
        below = node_idx < lo_o[:, None]
        above = node_idx > hi_o[:, None]
        f_node_s = torch.where(
            below,
            f_lo_val - (lo_o[:, None] - node_idx).to(dt64) * step,
            torch.where(above, f_hi_val + (node_idx - hi_o[:, None]).to(dt64) * step, f_n),
        )
        f_start, f_end = f_lo_val, f_hi_val  # (B, 1)

        # per-interval coefficients (interval i: node i -> node i+1):
        # Hermite in xi = (f - f_lo)/df with exact d/dxi = -2 pi t df
        df_n = torch.diff(f_node_s, dim=-1, append=f_node_s[:, -1:] + 1.0)
        inv_df = 1.0 / torch.where(torch.abs(df_n) > 0, df_n, torch.ones_like(df_n))
        psi_hi = torch.roll(psi_n, -1, dims=-1)
        t_hi = torch.roll(t_node_o, -1, dims=-1)
        d_lo = -_TWO_PI * t_node_o * df_n
        d_hi = -_TWO_PI * t_hi * df_n
        dpsi = psi_hi - psi_n
        p1 = d_lo
        p2 = 3.0 * dpsi - 2.0 * d_lo - d_hi
        p3 = -2.0 * dpsi + d_lo + d_hi
        # linear polar envelope, anchored at the window-start node so
        # garbage out-of-window nodes cannot shift in-window phases
        e_abs, e_phs = _polar_envelope(e_re, e_im, anchor=lo_o)
        tabs = [e_abs, torch.roll(e_abs, -1, dims=-1) - e_abs,
                e_phs, torch.roll(e_phs, -1, dims=-1) - e_phs]
        # a non-finite in-window node would poison its two intervals
        ea0, dea, ep0, dep = (torch.where(torch.isfinite(v), v, torch.zeros_like(v)) for v in tabs)

        in_range = (f_grid >= f_start) & (f_grid <= f_end)

        # ===== Level 2: dense evaluation =====
        # interval index = (number of nodes at or below the bin) - 1, from
        # the nodes' positions in the sorted bin grid (a node equal to a bin
        # counts for that bin)
        edge_pos = torch.searchsorted(f_pos, f_node_s.contiguous(), right=False)  # (B, N)
        counts = torch.zeros((n_b, nf + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, edge_pos, torch.ones_like(edge_pos, dtype=torch.int32))
        j = (torch.cumsum(counts[:, :nf], dim=-1) - 1).clamp(0, n_nodes - 2)

        xi64 = (f_grid - at(f_node_s, j)) * at(inv_df, j)
        xi = xi64.to(f32)
        psi64 = at(psi_n, j) + xi64 * (at(p1, j) + xi64 * (at(p2, j) + xi64 * at(p3, j)))
        psi32 = (psi64 - _TWO_PI * torch.round(psi64 * (1.0 / _TWO_PI))).to(f32)
        amp_b = at(ea0, j) + xi * at(dea, j)
        psi32 = psi32 + at(ep0, j) + xi * at(dep, j)
        keep = in_range & (live_i > 0)[:, None]
        zero = torch.zeros((), dtype=f32, device=dev)
        c_re = torch.where(keep, amp_b * torch.cos(psi32), zero)
        c_im = torch.where(keep, amp_b * torch.sin(psi32), zero)

        w1r32, w1i32, w2r32, w2i32 = (w.to(f32)[:, None] for w in (w1r, w1i, w2r, w2i))
        out[0] = out[0] + c_re * w1r32 - c_im * w1i32
        out[1] = out[1] + c_re * w1i32 + c_im * w1r32
        out[2] = out[2] + c_re * w2r32 - c_im * w2i32
        out[3] = out[3] + c_re * w2i32 + c_im * w2r32
    return tuple(o.to(f_pos.dtype) for o in out)


def fd_mode_sum_uniform(
    inp: FDKernelInputs,
    f0: float,
    df: float,
    nf: int,
    *,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    band_offsets: torch.Tensor | None = None,
    turnover_slots: int = 0,
    negative_slots: int = 0,
    band_offsets_extra: torch.Tensor | None = None,
    extra_band_runs: int | None = None,
    out_dtype: torch.dtype | None = None,
    bin_range: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Banded FD summation on the uniform grid f = f0 + i df, i < nf.

    Arguments as in the reference: per-slot windows of ``band_runs`` runs of
    ``bins_per_run`` bins (None = the whole grid); ``band_offsets`` (k,) window
    start runs shared by the batch (None = derived per lane); extra slots for
    the decreasing (turnover) and negative-frequency branches, picked per lane
    by power, with their own ``extra_band_runs`` window and
    ``band_offsets_extra``.

    ``bin_range=(lo, hi)`` computes only the bins lo <= i < hi of that grid
    (lo a multiple of ``bins_per_run``: a frequency shard): every window and
    table is laid out on the whole grid as before and the dense pass places
    bin i at output column i - lo, so each bin comes out of the same
    arithmetic as in the whole-grid call, to the bit.

    Returns (o1_re, o1_im, o2_re, o2_im), each (B, nf) (or (B, hi - lo)),
    in ``out_dtype`` (default: the trajectory's float64; the dense pass
    itself is float32).
    """
    t_knots = inp.t_knots
    dev = t_knots.device
    r = bins_per_run
    lo, hi = (0, nf) if bin_range is None else (int(bin_range[0]), int(bin_range[1]))
    if lo % r or not 0 <= lo < hi <= nf:
        raise ValueError(f"bin_range ({lo}, {hi}): expected 0 <= lo < hi <= nf = {nf} with lo "
                         f"a multiple of bins_per_run = {r}")
    g_total = -(-nf // r)  # runs covering the grid
    g_band = g_total if band_runs is None else min(band_runs, g_total)
    run_df = r * df
    n_b = t_knots.shape[0]

    cphi_all = (
        inp.m_sel[..., None, None] * inp.c_phi_phi[:, None]
        + inp.n_sel[..., None, None] * inp.c_phi_r[:, None]
    )  # (B, k, K-1, 4)
    f_knots_all = (
        inp.m_sel[..., None] * inp.f_phi_knots[:, None, :]
        + inp.n_sel[..., None] * inp.f_r_knots[:, None, :]
    )  # (B, k, K)
    k_max = cphi_all.shape[1]

    def ones(n):
        return torch.ones((n_b, n), dtype=torch.int32, device=dev)

    def pick_of(live, n_slots):
        # the highest-power modes with a live branch, ties to the lower slot
        return top_k_stable(live * (inp.power + 1e-300), min(n_slots, k_max))[1]

    # extra slots: (cphi, ar, ai, f_knots, k_lo, k_hi, dirn, live, weights)
    extras = []
    if turnover_slots > 0:
        pick = pick_of(inp.dec_live, turnover_slots)
        extras.append((
            _take(cphi_all, pick), _take(inp.ar_c, pick), _take(inp.ai_c, pick),
            _take(f_knots_all, pick), _take(inp.dec_lo, pick), _take(inp.dec_hi, pick),
            -ones(pick.shape[1]), _take(inp.dec_live, pick),
            [_take(w, pick) for w in (inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im)],
        ))
    if negative_slots > 0:
        pick_n = pick_of(inp.neg_live, negative_slots)
        # U = -Phi: negated phase coefficients, A in place of conj(A),
        # mirrored knot frequencies, neg weight pairs
        extras.append((
            -_take(cphi_all, pick_n), _take(inp.ar_c, pick_n), -_take(inp.ai_c, pick_n),
            -_take(f_knots_all, pick_n), _take(inp.neg_lo, pick_n), _take(inp.neg_hi, pick_n),
            ones(pick_n.shape[1]), _take(inp.neg_live, pick_n),
            [_take(w, pick_n) for w in (inp.w1n_re, inp.w1n_im, inp.w2n_re, inp.w2n_im)],
        ))

    # main-slot window offsets (the clip keeps every window inside the
    # padded accumulation space, so no window is shifted)
    if band_offsets is None:
        f_start_main = torch.gather(f_knots_all, 2, inp.inc_lo[..., None].long())[..., 0]
        g0_main = _to_int32(torch.floor((f_start_main - f0) / run_df))
    else:
        g0_main = torch.as_tensor(band_offsets, device=dev).to(torch.int32).expand(n_b, -1)
    g0_main = g0_main.clamp(0, g_total)

    # the exact integer-cycle phase needs the bins on a power-of-two lattice
    cyc = (r & (r - 1)) == 0

    tables = _level1_walker_chunks(
        cphi_all, inp.ar_c, inp.ai_c, f_knots_all, g0_main, inp.inc_lo, inp.inc_hi,
        ones(k_max), t_knots, f0, df, r, g_band + 1, run_df, cycle_split=cyc,
    )
    groups = [_dense_group(tables, inp.inc_live, [inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im],
                           g0_main, f0, df, r)]

    if extras:
        g_band_x = g_band if extra_band_runs is None else min(extra_band_runs, g_total)
        ex = [torch.cat([e[i] for e in extras], dim=1) for i in range(8)]
        ex_w = [torch.cat([e[8][i] for e in extras], dim=1) for i in range(4)]
        if band_offsets_extra is not None:
            g0_x = torch.as_tensor(band_offsets_extra, device=dev).to(torch.int32).expand(n_b, -1)
        else:
            f_start_x = torch.gather(
                ex[3], 2, torch.where(ex[6] > 0, ex[4], ex[5])[..., None].long()
            )[..., 0]
            g0_x = _to_int32(torch.floor((f_start_x - f0) / run_df))
        g0_x = g0_x.clamp(0, g_total)
        tables_x = _level1_walker_chunks(
            ex[0], ex[1], ex[2], ex[3], g0_x, ex[4], ex[5], ex[6],
            t_knots, f0, df, r, g_band_x + 1, run_df, cycle_split=cyc,
        )
        groups.append(_dense_group(tables_x, ex[7], ex_w, g0_x, f0, df, r))

    if lo:
        # window starts relative to the shard's first run (negative for a
        # window that begins before it; the dense pass drops those bins)
        groups = [g._replace(g0=(g.g0 - lo // r).contiguous()) for g in groups]
    out = fd_dense_accumulate(groups, r=r, nf=hi - lo)  # (B, 4, hi - lo) float32
    dt_out = t_knots.dtype if out_dtype is None else out_dtype
    return tuple(out[:, c].to(dt_out) for c in range(4))


def _dense_group(tables, live, weights, g0, f0, df, r) -> DenseGroup:
    """Kernel arguments of one slot group.

    The band limits fold to window-local bin indices once per slot, in
    float64: bin i is kept iff ceil((f_start - f0)/df) <= i + g0 r <=
    floor((f_end - f0)/df); dead slots get i_lo = INT32_MAX.
    """
    pc, nc, ec, f_start, f_end = tables
    g0 = g0.to(torch.int32)
    i_lo = _to_int32(torch.ceil((f_start - f0) / df)) - g0 * r
    i_hi = _to_int32(torch.floor((f_end - f0) / df)) - g0 * r
    i_lo = torch.where(live > 0, i_lo, torch.full_like(i_lo, _INT32_MAX))
    w = torch.stack([x.to(torch.float32) for x in weights], dim=-1)
    return DenseGroup(
        pc=pc.contiguous(), nc=nc.contiguous(), ec=ec.contiguous(),
        i_lo=i_lo.contiguous(), i_hi=i_hi.contiguous(), w=w.contiguous(), g0=g0.contiguous(),
    )


def _split_round(x: torch.Tensor) -> torch.Tensor:
    """float64 rounded through an exact (hi, lo) float32 pair: hi + lo."""
    hi = x.to(torch.float32).to(x.dtype)
    return hi + (x - hi).to(torch.float32).to(x.dtype)


def _polar_envelope(e_re: torch.Tensor, e_im: torch.Tensor, anchor=None):
    """Node-wise (signed modulus, continuous phase) of a complex envelope.

    Per-node steps of arg E fold into (-pi/2, pi/2], each discarded
    half-turn flipping the sign of the modulus; non-finite steps are zeroed
    and the phase re-anchored at node ``anchor`` (default 0) so
    s_k e^{i phs_k} = E_k (mod 2 pi). See the reference for the rationale.
    """
    pi_ = math.pi
    e_abs = torch.sqrt(e_re * e_re + e_im * e_im)
    raw = torch.atan2(e_im, e_re)
    d = torch.diff(raw, dim=-1)
    n = torch.round(d * (1.0 / pi_))
    ok = torch.isfinite(d)
    d = torch.where(ok, d - n * pi_, torch.zeros_like(d))
    n = torch.where(ok, n, torch.zeros_like(n))
    zero = torch.zeros_like(raw[..., :1])
    # a fixed-order running sum: torch.cumsum's order on the card follows the
    # number of rows (ops/row_ops.py); the parities are integers, exact in
    # any order
    phs = torch.cat([zero, row_cumsum(d)], dim=-1)
    par = torch.cat([zero, torch.cumsum(n, dim=-1)], dim=-1)
    sign = 1.0 - 2.0 * torch.remainder(par, 2.0)
    if anchor is None:
        idx = torch.zeros(raw.shape[:-1] + (1,), dtype=torch.long, device=raw.device)
    else:
        idx = torch.as_tensor(anchor, device=raw.device).long().clamp(0, raw.shape[-1] - 1)
        idx = idx.expand(raw.shape[:-1]).unsqueeze(-1)
    raw_a = torch.gather(raw, -1, idx)
    phs_a = torch.gather(phs, -1, idx)
    par_a = torch.gather(par, -1, idx)
    # reduce the parity before multiplying by pi so c stays rotation-sized
    c = torch.where(
        torch.isfinite(raw_a), phs_a + pi_ * torch.remainder(par_a, 2.0) - raw_a,
        torch.zeros_like(raw_a),
    )
    return sign * e_abs, phs - c


# level-1 nodes (walkers x slots x window nodes) evaluated in one pass: its
# float64 intermediates take ~0.7 kB a node, so a larger batch is evaluated
# in walker chunks of at most this many nodes (a 16-walker batch of 48
# whole-grid slots on the 4-yr, 6.3M-bin grid: 75.7M nodes, 52 GB at once)
_LEVEL1_NODES = 1 << 25


def _level1_walker_chunks(cphi_all, ar_all, ai_all, f_knots_all, g0_all, k_lo, k_hi, dirn,
                          t_knots, f0, df, r, n_nodes, run_df, cycle_split=False):
    """`_level1_uniform_tables` in chunks of walkers of at most
    `_LEVEL1_NODES` nodes, concatenated: every node's arithmetic runs per
    walker and slot (the envelope's running sum per row, `row_cumsum`), so
    the tables are those of one pass, to the bit."""
    n_b, n_s = f_knots_all.shape[:2]
    step = max(1, _LEVEL1_NODES // (n_s * n_nodes))
    parts = [
        _level1_uniform_tables(*(x[b:b + step] for x in (cphi_all, ar_all, ai_all, f_knots_all,
                                                         g0_all, k_lo, k_hi, dirn, t_knots)),
                               f0, df, r, n_nodes, run_df, cycle_split=cycle_split)
        for b in range(0, n_b, step)
    ]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(col, dim=0) for col in zip(*parts))


def _level1_uniform_tables(
    cphi_all,  # (B, S, K-1, 4) float64 per-slot phase spline coefficients
    ar_all,  # (B, S, K-1, 4) float64 amplitude-re spline coefficients
    ai_all,
    f_knots_all,  # (B, S, K) float64 knot frequencies of the slot's phase
    g0_all,  # (B, S) int32 window-start runs
    k_lo,  # (B, S) int32 first knot of the slot's monotone window
    k_hi,  # (B, S) int32 last knot (inclusive)
    dirn,  # (B, S) int32: +1 increasing-in-t branch, -1 decreasing
    t_knots,  # (B, K) float64
    f0: float,
    df: float,
    r: int,
    n_nodes: int,
    run_df: float,
    cycle_split: bool = False,
):
    """Level-1 node evaluation for all slots of a batch.

    Returns per-run tables for the dense pass: phase Hermite pc (B, S, G, 4)
    float32, integer 2pi-cycle counts nc (B, S, G, 3) int32 (zeros unless
    ``cycle_split``), envelope coefficients ec (B, S, G, 8) float32, and the
    oriented band limits f_start, f_end (B, S) float64, with G = n_nodes - 1.
    """
    f32 = torch.float32
    dev = t_knots.device
    k = t_knots.shape[-1]
    dt64 = t_knots.dtype
    k_lo = k_lo.long()
    k_hi = k_hi.long()

    inc = dirn > 0
    # oriented band limits: ascending-f traversal starts at k_lo (inc) or k_hi (dec)
    idx_start = torch.where(inc, k_lo, k_hi)[..., None]
    idx_end = torch.where(inc, k_hi, k_lo)[..., None]
    f_start = torch.gather(f_knots_all, -1, idx_start)[..., 0]
    f_end = torch.gather(f_knots_all, -1, idx_end)[..., 0]
    f_node = f0 + (
        g0_all.to(dt64)[..., None] + torch.arange(n_nodes, dtype=dt64, device=dev)
    ) * run_df  # (B, S, N)

    # --- segment assignment: count of oriented interior boundaries <= f_node,
    # compared in float32 as in the reference; boundaries past the window
    # are a huge increasing ramp, so the count stops at the window end ---
    win_len = k_hi - k_lo
    jj = torch.arange(1, k - 1, device=dev)
    idx_bnd = torch.where(inc[..., None], k_lo[..., None] + jj, k_hi[..., None] - jj)
    f_bnd = torch.gather(f_knots_all.to(f32), -1, idx_bnd.clamp(0, k - 1))
    bnd = torch.where(
        jj <= (win_len[..., None] - 1), f_bnd, 1e30 * (1.0 + jj.to(f32))
    )
    count = torch.searchsorted(bnd.contiguous(), f_node.to(f32).contiguous(), right=True)
    seg = torch.where(inc[..., None], k_lo[..., None] + count, k_hi[..., None] - 1 - count)
    seg = seg.clamp(0, k - 2)  # (B, S, N) actual trajectory segment

    def gather_seg(tab):  # tab (B, S, K-1, C) -> (B, S, N, C)
        return torch.gather(tab, 2, seg[..., None].expand(seg.shape + tab.shape[-1:]))

    c = _split_round(gather_seg(cphi_all))
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    t_seg = t_knots[:, None, :-1].expand(seg.shape[:2] + (k - 1,))[..., None]
    t_lo = _split_round(gather_seg(t_seg))[..., 0]
    h_seg32 = torch.diff(t_knots, dim=-1).to(f32).to(dt64)
    h_seg = gather_seg(h_seg32[:, None, :, None].expand(seg.shape[:2] + (k - 1, 1)))[..., 0]
    f_pair = torch.stack([f_knots_all[..., :-1], f_knots_all[..., 1:]], dim=-1).to(f32).to(dt64)
    f_lo_hi = gather_seg(f_pair)
    f_lo, f_hi = f_lo_hi[..., 0], f_lo_hi[..., 1]
    ar = gather_seg(ar_all.to(f32))
    ai = gather_seg(ai_all.to(f32))

    # --- Newton for dx: Phi'(dx) = 2 pi f_node (3 steps); nodes just outside
    # the band extrapolate the edge segment's cubic mildly ---
    y = _TWO_PI * f_node
    denom = torch.where(torch.abs(f_hi - f_lo) > 0, f_hi - f_lo, torch.ones_like(f_hi))
    dx = torch.clamp((f_node - f_lo) / denom, -0.5, 1.5) * h_seg
    for _ in range(3):
        fp = c1 + dx * (2.0 * c2 + 3.0 * c3 * dx) - y
        fpp = 2.0 * c2 + 6.0 * c3 * dx
        fpp = torch.where(torch.abs(fpp) > 1e-300, fpp, torch.full_like(fpp, 1e-300))
        dx = torch.minimum(torch.maximum(dx - fp / fpp, -0.5 * h_seg), 1.5 * h_seg)
    t_star = t_lo + dx

    phi = c0 + dx * (c1 + dx * (c2 + dx * c3))
    psi = phi - y * t_star
    # envelope quantities at the in-segment point
    dx_env = torch.minimum(torch.maximum(dx, torch.zeros_like(dx)), h_seg)
    fdot = torch.clamp_min(torch.abs(2.0 * c2 + 6.0 * c3 * dx_env) / _TWO_PI, 1e-300)
    fddot = (6.0 * c3) / _TWO_PI

    dx32 = dx_env.to(f32)
    a_re = ar[..., 0] + dx32 * (ar[..., 1] + dx32 * (ar[..., 2] + dx32 * ar[..., 3]))
    a_im = ai[..., 0] + dx32 * (ai[..., 1] + dx32 * (ai[..., 2] + dx32 * ai[..., 3]))
    w_arg = -_TWO_PI * (fdot * fdot * fdot) / (3.0 * torch.clamp_min(fddot * fddot, 1e-300))
    w32 = torch.clamp(w_arg, -1e12, -1e-30).to(f32)
    k_re, k_im = kve_one_third_imag(w32)
    # decreasing branch: the SPA factor is the complex conjugate
    k_im = k_im * dirn[..., None].to(f32)
    corr = torch.sqrt(2.0 * torch.abs(w32) * _f32(1.0 / math.pi))
    inv_sq = torch.rsqrt(torch.clamp_min(fdot.to(f32), _f32(1e-37)))
    cr_f = k_re * corr * inv_sq
    ci_f = k_im * corr * inv_sq
    e_re = a_re * cr_f + a_im * ci_f
    e_im = a_re * ci_f - a_im * cr_f

    # --- anchored node quantities at the band-clamped point ---
    f_eff = (c1 + dx_env * (2.0 * c2 + 3.0 * c3 * dx_env)) / _TWO_PI
    t_eff = t_lo + dx_env
    phi_eff = c0 + dx_env * (c1 + dx_env * (c2 + dx_env * c3))
    psi_eff = phi_eff - _TWO_PI * f_eff * t_eff

    # --- per-run phase coefficients (intervals g -> g+1), plain Hermite ---
    psi_lo, psi_hi = psi[..., :-1], psi[..., 1:]
    d_lo = -_TWO_PI * t_star[..., :-1] * run_df
    d_hi = -_TWO_PI * t_star[..., 1:] * run_df
    dpsi = psi_hi - psi_lo
    p0_plain = psi_lo
    p1_plain = d_lo
    p2_plain = 3.0 * dpsi - 2.0 * d_lo - d_hi
    p3_plain = -2.0 * dpsi + d_lo + d_hi

    # anchored Hermite through the clamped anchors, composed into an
    # xi-polynomial in float32 (band-edge intervals)
    xa = ((f_eff[..., :-1] - f_node[..., :-1]) / run_df).to(f32)
    xb = ((f_eff[..., 1:] - f_node[..., :-1]) / run_df).to(f32)
    span = xb - xa
    anchored = span >= 0.125
    span_safe = torch.where(anchored, span, torch.ones_like(span))
    psi_a = psi_eff[..., :-1]
    da = (-_TWO_PI * run_df) * t_eff[..., :-1]
    db = (-_TWO_PI * run_df) * t_eff[..., 1:]
    dpsi_a = (psi_eff[..., 1:] - psi_a).to(f32)
    q0 = (psi_a - _TWO_PI * torch.round(psi_a * (1.0 / _TWO_PI))).to(f32)
    da32, db32 = da.to(f32), db.to(f32)
    q1 = span_safe * da32
    q2 = 3.0 * dpsi_a - span_safe * (2.0 * da32 + db32)
    q3 = -2.0 * dpsi_a + span_safe * (da32 + db32)
    beta = 1.0 / span_safe
    alpha = -xa * beta
    c0_anc = q0 + alpha * (q1 + alpha * (q2 + alpha * q3))
    c1_anc = beta * (q1 + alpha * (2.0 * q2 + 3.0 * alpha * q3))
    c2_anc = beta * beta * (q2 + 3.0 * alpha * q3)
    c3_anc = beta * beta * beta * q3
    two_pi32 = _f32(_TWO_PI)
    c0_anc = c0_anc - two_pi32 * torch.round(c0_anc * _f32(1.0 / _TWO_PI))

    use_anc = anchored & ((xa > _f32(1e-4)) | (xb < _f32(1.0 - 1e-4)))
    p0_plain32 = (p0_plain - _TWO_PI * torch.round(p0_plain * (1.0 / _TWO_PI))).to(f32)
    p0c = torch.where(use_anc, c0_anc, p0_plain32)
    if cycle_split:
        # exact integer-cycle split; out-of-window garbage intervals are
        # zeroed so the int32 cycle counts never overflow
        def split64(p):
            ok = torch.isfinite(p) & (torch.abs(p) < 2.0e5)
            n = torch.where(ok, torch.round(p * (1.0 / _TWO_PI)), torch.zeros_like(p))
            q = torch.where(ok, p - _TWO_PI * n, torch.zeros_like(p))
            return q.to(f32), n.to(torch.int32)

        def split32(cf):
            ok = torch.isfinite(cf) & (torch.abs(cf) < _f32(2.0e5))
            n = torch.where(ok, torch.round(cf * _f32(1.0 / _TWO_PI)), torch.zeros_like(cf))
            q = torch.where(ok, cf - n * two_pi32, torch.zeros_like(cf))
            return q, n.to(torch.int32)

        q1p, n1p = split64(p1_plain)
        q2p, n2p = split64(p2_plain)
        q3p, n3p = split64(p3_plain)
        q1a, n1a = split32(c1_anc)
        q2a, n2a = split32(c2_anc)
        q3a, n3a = split32(c3_anc)
        p1c = torch.where(use_anc, q1a, q1p)
        p2c = torch.where(use_anc, q2a, q2p)
        p3c = torch.where(use_anc, q3a, q3p)
        nc = torch.stack(
            [torch.where(use_anc, n1a, n1p), torch.where(use_anc, n2a, n2p),
             torch.where(use_anc, n3a, n3p)],
            dim=-1,
        )
    else:
        p1c = torch.where(use_anc, c1_anc, p1_plain.to(f32))
        p2c = torch.where(use_anc, c2_anc, p2_plain.to(f32))
        p3c = torch.where(use_anc, c3_anc, p3_plain.to(f32))
        nc = torch.zeros(p1c.shape + (3,), dtype=torch.int32, device=dev)

    # --- polar envelope, Catmull-Rom cubic from values at g-1, g, g+1, g+2 ---
    e_abs, e_phs = _polar_envelope(e_re, e_im)

    def cr_coeffs(v):
        vm = torch.cat([v[..., :1], v[..., :-1]], dim=-1)[..., :-1]
        v0 = v[..., :-1]
        v1 = v[..., 1:]
        vp = torch.cat([v[..., 1:], v[..., -1:]], dim=-1)[..., 1:]
        s0 = 0.5 * (v1 - vm)
        s1 = 0.5 * (vp - v0)
        return v0, s0, 3.0 * (v1 - v0) - 2.0 * s0 - s1, -2.0 * (v1 - v0) + s0 + s1

    er0, er1, er2, er3 = cr_coeffs(e_abs)
    ei0, ei1, ei2, ei3 = cr_coeffs(e_phs)

    # band-edge intervals: affine envelope between the exact anchors
    def edge_affine(v):
        v0 = v[..., :-1]
        d = (v[..., 1:] - v0) * beta
        return v0 - xa * d, d

    er0_l, er1_l = edge_affine(e_abs)
    ei0_l, ei1_l = edge_affine(e_phs)
    zero32 = torch.zeros_like(er0_l)
    er0 = torch.where(use_anc, er0_l, er0)
    er1 = torch.where(use_anc, er1_l, er1)
    er2 = torch.where(use_anc, zero32, er2)
    er3 = torch.where(use_anc, zero32, er3)
    ei0 = torch.where(use_anc, ei0_l, ei0)
    ei1 = torch.where(use_anc, ei1_l, ei1)
    ei2 = torch.where(use_anc, zero32, ei2)
    ei3 = torch.where(use_anc, zero32, ei3)

    pc = torch.stack([p0c, p1c, p2c, p3c], dim=-1)
    ec = torch.stack([er0, er1, er2, er3, ei0, ei1, ei2, ei3], dim=-1)
    # sanitize: masked / garbage slots can carry NaN through the tables
    pc = torch.where(torch.isfinite(pc), pc, torch.zeros_like(pc))
    ec = torch.where(torch.isfinite(ec), ec, torch.zeros_like(ec))
    return pc, nc, ec, f_start, f_end


def _pallas_layout(nf: int, r: int, band_runs: int | None) -> tuple[int, int]:
    """(runs covering the grid, window runs padded to a multiple of 128), the
    reference's Pallas layout."""
    g_total = -(-nf // r)
    g_band = g_total if band_runs is None else min(band_runs, g_total)
    return g_total, -(-g_band // 128) * 128


def _round_offsets(g0: torch.Tensor, g_total: int) -> torch.Tensor:
    """Window starts rounded DOWN to 128-run boundaries, clipped to
    [0, g_total]: each window then begins up to 127 runs below its band, so
    ``band_runs`` must hold 128 runs of slack above the band width."""
    g0 = torch.div(g0.to(torch.int32), 128, rounding_mode="floor") * 128
    return g0.clamp(0, g_total)


def _pallas_sum(inp: FDKernelInputs, g0: torch.Tensor, f0: float, df: float, nf: int, r: int,
                g_band: int):
    """One slot group (no extra slots) with windows of ``g_band`` runs at the
    window starts ``g0`` (B, k): the port's level-1 tables into
    `fd_dense_accumulate`, outputs cast to the trajectory's dtype."""
    t_knots = inp.t_knots
    cphi_all = (
        inp.m_sel[..., None, None] * inp.c_phi_phi[:, None]
        + inp.n_sel[..., None, None] * inp.c_phi_r[:, None]
    )
    f_knots_all = (
        inp.m_sel[..., None] * inp.f_phi_knots[:, None, :]
        + inp.n_sel[..., None] * inp.f_r_knots[:, None, :]
    )
    ones = torch.ones(g0.shape, dtype=torch.int32, device=t_knots.device)
    tables = _level1_uniform_tables(
        cphi_all, inp.ar_c, inp.ai_c, f_knots_all, g0, inp.inc_lo, inp.inc_hi, ones, t_knots,
        f0, df, r, g_band + 1, r * df, cycle_split=(r & (r - 1)) == 0,
    )
    group = _dense_group(tables, inp.inc_live, [inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im],
                         g0, f0, df, r)
    out = fd_dense_accumulate([group], r=r, nf=nf)
    return tuple(out[:, c].to(t_knots.dtype) for c in range(4))


def fd_mode_sum_uniform_pallas(
    inp: FDKernelInputs,
    f0: float,
    df: float,
    nf: int,
    *,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    band_offsets: torch.Tensor | None = None,
    interpret: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's Pallas-named banded FD summation -> 4 tensors (B, nf).

    A thin wrapper with the reference's contract: one slot group (no
    turnover or negative slots), the increasing branch of every slot with
    its ``inc_live`` flag and (w1, w2) weights; windows of ``band_runs``
    runs padded up to a multiple of 128; each walker's window starts taken
    from ``band_offsets`` (k,) or, when None, from its slots' first knot
    frequencies, then rounded down to 128-run boundaries and clipped to
    [0, ceil(nf / bins_per_run)]. The dense pass is
    `ops.fd_dense.fd_dense_accumulate`: the CUDA kernel on the card, its
    plain version on the CPU. Outputs are cast to ``inp.t_knots``' dtype.
    ``interpret`` is accepted for the reference's signature and ignored:
    the device of ``inp`` decides.
    """
    del interpret
    r = bins_per_run
    g_total, g_band = _pallas_layout(nf, r, band_runs)
    n_b, k = inp.m_sel.shape
    if band_offsets is None:
        f_first = inp.m_sel * inp.f_phi_knots[:, :1] + inp.n_sel * inp.f_r_knots[:, :1]
        g0 = _to_int32(torch.floor((f_first - f0) / (r * df)))
    else:
        g0 = torch.as_tensor(band_offsets, device=inp.t_knots.device).expand(n_b, k)
    return _pallas_sum(inp, _round_offsets(g0, g_total), f0, df, nf, r, g_band)


def fd_mode_sum_uniform_pallas_batched(
    inp_b: FDKernelInputs,
    f0: float,
    df: float,
    nf: int,
    *,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    band_offsets: torch.Tensor | None = None,
    interpret: bool = False,
):
    """Walker-batched form of `fd_mode_sum_uniform_pallas` -> 4 tensors
    (B, nf): the window starts are shared by the batch and must be given
    (``band_offsets`` (k,), e.g. from `models.waveform.band_offsets_for`);
    without them it raises ValueError, as the reference does. ``interpret``
    is ignored, as there."""
    del interpret
    if band_offsets is None:
        raise ValueError("batched pallas path requires shared band_offsets")
    return fd_mode_sum_uniform_pallas(
        inp_b, f0, df, nf, bins_per_run=bins_per_run, band_runs=band_runs,
        band_offsets=band_offsets)


__all__ = [
    "FDKernelInputs",
    "prepare_fd_inputs",
    "fd_mode_sum",
    "fd_mode_sum_uniform",
    "fd_mode_sum_uniform_pallas",
    "fd_mode_sum_uniform_pallas_batched",
]
