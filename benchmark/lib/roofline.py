"""The yardstick of the kernels' roofline shares, frozen here so that a later
change to the program cannot move it.

Copies: the peaks and per-cell byte counts of ``chip_smoke.py`` (HBM 3.35
TB/s, float32 67 TFLOP/s and float64 34 TFLOP/s outside the tensor cores,
NVIDIA's H100 SXM data sheet), its ``bound`` of the dense pass, the row
kernels' byte count, and ``testing/fd_dense_cases.py``'s ``kept_bands``,
``kept_pairs`` and ``kept_runs``. ``tests/test_bench_frozen.py`` holds them
equal to their sources.

A bound is the least time the card could take for one launch: the larger of
its bytes at the HBM peak and its operations at the arithmetic peak.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 peak outside the tensor cores
OPS_PER_PAIR = 64
CELL_BYTES = 4 * 4 + 3 * 4 + 8 * 4  # one (slot, run) cell of pc, nc and ec
SLOT_BYTES = 3 * 4 + 4 * 4  # one slot's i_lo, i_hi, g0 and w


def kept_bands(grp, r: int, nf: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), (B, S) int64: each slot's kept band in output bins, clipped
    to its window and to [0, nf); empty (lo > hi) for a dead slot."""
    base = grp.g0.long() * r
    lo = base + grp.i_lo.long().clamp_min(0)
    hi = base + grp.i_hi.long().clamp_max(grp.pc.shape[2] * r - 1)
    return lo, hi.clamp_max(nf - 1)


def kept_pairs(groups, r: int, nf: int) -> int:
    """Number of (bin, slot) pairs inside the kept bands and the grid: the
    sin/cos evaluations a call needs."""
    n = 0
    for grp in groups:
        lo, hi = kept_bands(grp, r, nf)
        n += int((hi - lo + 1).clamp_min(0).sum())
    return n


def kept_runs(groups, r: int, nf: int) -> int:
    """Number of (slot, run) coefficient cells that some kept bin of the
    grid lies in: the table cells a call must read."""
    n = 0
    for grp in groups:
        lo, hi = kept_bands(grp, r, nf)
        base = grp.g0.long() * r
        runs = torch.div(hi - base, r, rounding_mode="floor") - torch.div(
            lo - base, r, rounding_mode="floor") + 1
        n += int(torch.where(lo <= hi, runs, 0).sum())
    return n


def fd_dense_bound_s(groups, r: int, nf: int) -> float:
    """Seconds: the least time of one dense-pass launch on these tables. The
    bytes: each coefficient cell that a kept bin inside the grid lies in,
    and each slot's scalars, read once; each output byte written once. The
    operations: OPS_PER_PAIR per kept (bin, slot) pair."""
    n_b = groups[0].pc.shape[0]
    n_bytes = (kept_runs(groups, r, nf) * CELL_BYTES
               + sum(g.pc.shape[1] for g in groups) * n_b * SLOT_BYTES + n_b * 4 * nf * 4)
    ops = kept_pairs(groups, r, nf) * OPS_PER_PAIR
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def row_cumsum_bound_s(x: torch.Tensor) -> float:
    """Seconds: the least time of one running sum over the last axis of
    ``x``: the input read once and the output written once, or one add per
    element at the peak of its dtype."""
    n_bytes = 2 * x.numel() * x.element_size()
    peak = F64_OPS_PER_S if x.dtype == torch.float64 else F32_OPS_PER_S
    return max(n_bytes / HBM_BYTES_PER_S, x.numel() / peak)
