"""Dense-pass tables for holding the CUDA kernel against its plain version.

`random_groups` draws slot tables at any shape; `adversarial_cases` is the
set of small layouts that stress the kernel's tiling (run sizes 1..128, grid
lengths that are not multiples of 4 or of the tile, windows across and past
the grid end, band edges inside a 4-bin vector, two slots on one window,
NaN in masked lanes, one and two slot groups, all slots dead). `kept_bands`
clips each slot's kept band to its window and the grid, as the kernel does;
from it `kept_mask` marks the bins some slot keeps (exactly 0 elsewhere),
`kept_pairs` counts the sin/cos evaluations a call needs and `kept_runs` the
(slot, run) coefficient cells it reads. The CPU tests and ``chip_smoke.py``
share them. Tables are made with numpy from the caller's generator and
returned as CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fd_dense import DenseGroup

DEAD = 2**31 - 1  # i_lo of a dead slot


class Case(NamedTuple):
    name: str
    groups: list
    r: int
    nf: int


def random_groups(rng, n_b, slots, r, nf, *, nan_masked=True) -> list[DenseGroup]:
    """Random slot groups; ``slots`` is a list of (n_slots, g_band) per group.

    Per group: slots 0 and 1 share a window, slot 2's window overlaps
    slot 0's, the last slot is dead, band edges fall inside runs, and (with
    ``nan_masked``) run 0, which lies below every kept band, holds NaN.
    """
    groups = []
    g_total = -(-nf // r)
    for n_s, g_band in slots:
        shape = (n_b, n_s, g_band)
        pc = rng.uniform(-3.0, 3.0, shape + (4,)).astype(np.float32)
        nc = rng.integers(-2000, 2000, shape + (3,)).astype(np.int32)
        if r & (r - 1):
            nc[:] = 0  # cycle counts exist only on a power-of-two lattice
        ec = rng.uniform(-1.0, 1.0, shape + (8,)).astype(np.float32)
        g0 = rng.integers(0, max(g_total - g_band // 2, 1), (n_b, n_s)).astype(np.int32)
        if n_s > 1:
            g0[:, 1] = g0[:, 0]
        if n_s > 2:
            g0[:, 2] = g0[:, 0] + g_band // 3
        i_lo = rng.integers(r, max(g_band * r // 3, r + 1), (n_b, n_s)).astype(np.int32)
        i_hi = (i_lo + rng.integers(r, g_band * r, (n_b, n_s))).astype(np.int32)
        i_lo[:, -1] = DEAD
        if nan_masked:
            pc[:, :, 0, :] = np.nan
            ec[:, :, 0, 5] = np.nan
        w = rng.standard_normal((n_b, n_s, 4)).astype(np.float32)
        groups.append(DenseGroup(
            *(torch.from_numpy(x) for x in (pc, nc, ec, i_lo, i_hi, w, g0))
        ))
    return groups


def _edit(grp: DenseGroup, **cols) -> DenseGroup:
    """A copy of ``grp`` with per-slot columns set: name -> {slot: value}."""
    fields = {}
    for name, per_slot in cols.items():
        t = getattr(grp, name).clone()
        for s, v in per_slot.items():
            t[:, s] = v
        fields[name] = t
    return grp._replace(**fields)


def adversarial_cases(rng) -> list[Case]:
    """Small layouts that stress the kernel's tiling; see the module docstring."""
    cases = []
    # run sizes 1..128; grid lengths not a multiple of 4 or of any tile size
    for r, nf, n_b, slots in (
        (1, 1001, 2, [(3, 40)]),
        (3, 2999, 1, [(5, 50), (2, 10)]),
        (8, 5003, 3, [(5, 64), (2, 16)]),
        (64, 70001, 2, [(5, 64)]),
        (128, 40961, 1, [(5, 32), (3, 8)]),
    ):
        g_total = -(-nf // r)
        grp0, *rest = random_groups(rng, n_b, slots, r, nf)
        n_g = grp0.pc.shape[2]
        # slots 0 and 1: one window across the grid end, slot 0's band
        # running past nf
        edits = {
            "g0": {0: g_total - n_g // 2, 1: g_total - n_g // 2},
            "i_lo": {0: r + 1},
            "i_hi": {0: n_g * r - 2},
        }
        if grp0.pc.shape[1] > 4:  # slot 4 stays dead
            edits["g0"][2] = g_total + 3  # a window entirely past the grid end
            # a 2-bin band inside one 4-bin vector (output bins 4k+1, 4k+2)
            g0_3 = g_total // 3
            lo3 = r + (1 - g0_3 * r - r) % 4
            edits["g0"][3] = g0_3
            edits["i_lo"][3] = lo3
            edits["i_hi"][3] = lo3 + 1
        else:
            # slot 2: a band from a negative i_lo, kept from output bin 0
            # (finite coefficients in run 0)
            edits.update(g0={**edits["g0"], 2: 0}, i_lo={**edits["i_lo"], 2: -3},
                         pc={2: 0.5}, ec={2: 0.25})
        cases.append(Case(f"r{r}_nf{nf}_B{n_b}_groups{len(slots)}", [_edit(grp0, **edits), *rest], r, nf))
    # every slot dead: the output is exactly zero
    r, nf = 8, 3001
    dead = [g._replace(i_lo=torch.full_like(g.i_lo, DEAD))
            for g in random_groups(rng, 2, [(4, 32), (2, 8)], r, nf)]
    cases.append(Case("all_dead", dead, r, nf))
    return cases


def kept_bands(grp: DenseGroup, r: int, nf: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), (B, S) int64: each slot's kept band in output bins, clipped
    to its window and to [0, nf); empty (lo > hi) for a dead slot."""
    base = grp.g0.long() * r
    lo = base + grp.i_lo.long().clamp_min(0)
    hi = base + grp.i_hi.long().clamp_max(grp.pc.shape[2] * r - 1)
    return lo, hi.clamp_max(nf - 1)


def kept_mask(groups, r: int, nf: int) -> torch.Tensor:
    """(B, nf) bool: bins inside some live slot's kept band."""
    n_b = groups[0].pc.shape[0]
    dev = groups[0].pc.device
    mask = torch.zeros((n_b, nf), dtype=torch.bool, device=dev)
    idx = torch.arange(nf, device=dev)
    for grp in groups:
        lo, hi = kept_bands(grp, r, nf)
        for s in range(grp.pc.shape[1]):
            mask |= (idx >= lo[:, s, None]) & (idx <= hi[:, s, None])
    return mask


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


__all__ = [
    "Case", "DEAD", "random_groups", "adversarial_cases", "kept_bands", "kept_mask",
    "kept_pairs", "kept_runs",
]
