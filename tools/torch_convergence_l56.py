"""Multipole-truncation convergence study on the PyTorch port: l <= 4 vs
l <= 6 inventories (and on through l = 10).

The port's counterpart of ``tools/convergence_l56.py``. Across a
check_mode_by_mode-style draw distribution it measures

  1. the fraction of total mode power carried by the l = 5, 6 families
     (and l = 7, 8 and 9, 10; detector-frame Ylm-weighted,
     trajectory-averaged), and
  2. full FD-waveform mismatches between l_max = 4 and l_max = 6 (6 / 8,
     8 / 10) generations on representative sources,

the convergence-based error bar on the multipole truncation: assuming the
observed geometric decay of power with l continues, the l <= 4 truncation
error is bounded by ~(l56 power)/(1 - decay ratio).

The draws' p0 come from one batched duration solve, and the four fixed
cases' from another (each lane's p0 does not depend on its batch).

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    PYTHONPATH=. python tools/torch_convergence_l56.py [--draws N] [--quick]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CASES = [
    (1e6, 10.0, 0.35, 0.9, 1.2),
    (1e6, 10.0, 0.6, 1.9, 4.0),
    (3e5, 30.0, 0.5, 0.7, 0.4),
    (1e6, 10.0, 0.7, 1.9, 4.0),  # prior edge e0 = 0.7
]
T_DRAW, T_CASE = 0.5, 0.15
SEED = 2601996


def _f64(x, device):
    import torch

    return torch.tensor(float(x), dtype=torch.float64, device=device)


def power_by_l(m_mass, mu, p0, e0, th, ph, t_years, table, max_steps=256, device=None):
    """Mode power summed per l along one source's inspiral: {l: power}
    (`knot_power_by_l` on its knots)."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import schwarz_ecc_flux_inspiral

    traj = schwarz_ecc_flux_inspiral(
        m_mass, mu, p0, e0, t_years=t_years, max_steps=max_steps, device=device
    )
    live = (torch.arange(traj.t.shape[1], device=traj.t.device) < traj.n[0]).to(traj.t.dtype)
    return knot_power_by_l(traj.p[0], traj.e[0], live, th, ph, table)


def knot_power_by_l(p, e, live, th, ph, table):
    """{l: dt-weighted mode power of the l families} over the knots (p, e),
    (K,) float64 tensors, the padded ones masked by ``live``."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import mode_amplitudes
    from emri_frequencydomainwaveforms_tpu_torch.models.modeselect import mode_power
    from emri_frequencydomainwaveforms_tpu_torch.utils.ylm import spin_weighted_ylm

    a_re, a_im = mode_amplitudes(p, e, table)
    th, ph = _f64(th, p.device), _f64(ph, p.device)
    yp = spin_weighted_ylm(table.ls, table.ms, th, ph)
    ym = spin_weighted_ylm(table.ls, -table.ms, th, ph)
    power = mode_power(a_re, a_im, yp[0], yp[1], ym[0], ym[1], dt_weights=live).cpu().numpy()
    out = {}
    for l_val in sorted(set(table.ls.tolist())):
        out[l_val] = float(power[table.ls == l_val].sum())
    return out


def fd_mismatch_lpair(m_mass, mu, p0, e0, th, ph, t_years, n_max=20, l_pair=(4, 6),
                      device=None):
    """Unwindowed FD mismatch between two l_max inventories."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import (
        fd_waveform_core,
        waveform_prologue,
    )

    out = {}
    for l_max in l_pair:
        table = default_mode_table(n_max, l_max=l_max)
        pro = waveform_prologue(
            m_mass, mu, p0, e0, th, ph, 1.0, 0.0, 0.0,
            t_years=t_years, table=table, k_max=192, eps=1e-8, device=device,
        )
        f_grid = torch.as_tensor(np.linspace(1e-4, 1.2e-2, 60000), device=pro.t_knots.device)
        o = fd_waveform_core(pro, table, f_grid, channels=True)
        out[l_max] = o[0][0].cpu().numpy() + 1j * o[1][0].cpu().numpy()
    a, b = (out[l] for l in l_pair)
    num = np.abs(np.vdot(a, b))
    den = np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real)
    return float(1.0 - num / den)


def draw_sources(draws: int, seed: int = SEED) -> np.ndarray:
    """(draws, 5) rows of (M, mu, e0, theta, phi) in the original's draw
    order (its duration solve never fails, so every draw takes its angles
    right after its masses and e0)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(draws):
        logm = rng.uniform(5.0, 6.5)
        m_mass = 10.0**logm
        mu = 10.0 ** rng.uniform(0.8, 1.8)
        e0 = rng.uniform(0.1, 0.7)  # full CLI prior range (cli/emri_pe.py)
        th, ph = np.arccos(rng.uniform(-1, 1)), rng.uniform(0, 2 * np.pi)
        rows.append((m_mass, mu, e0, th, ph))
    return np.asarray(rows)


def solve_p0(masses_e0: np.ndarray, t_years: float, device) -> np.ndarray:
    """p0 of a ``t_years`` inspiral for each (M, mu, e0) row, one batched solve."""
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import get_p_at_t

    m = np.asarray(masses_e0, dtype=np.float64)
    return get_p_at_t(m[:, 0], m[:, 1], m[:, 2], t_years, device=device).cpu().numpy()


def report_of(powers, mms, mms68, mms810):
    """The study's printed lines and JSON report from the per-draw power
    dicts and the fixed cases' mismatches."""
    fracs56, fracs78, fracs910, ratios, ratio_chains = [], [], [], [], []
    for pb in powers:
        tot = sum(pb.values())
        fracs56.append((pb.get(5, 0.0) + pb.get(6, 0.0)) / tot)
        fracs78.append((pb.get(7, 0.0) + pb.get(8, 0.0)) / tot)
        fracs910.append((pb.get(9, 0.0) + pb.get(10, 0.0)) / tot)
        if pb.get(4, 0.0) > 0 and pb.get(5, 0.0) > 0:
            ratios.append(pb[5] / pb[4])
        chain = [pb.get(l, 0.0) for l in (5, 6, 7, 8, 9, 10)]
        if all(v > 0 for v in chain):
            ratio_chains.append([chain[i + 1] / chain[i] for i in range(5)])

    fracs56 = np.asarray(fracs56)
    fracs78 = np.asarray(fracs78)
    fracs910 = np.asarray(fracs910)
    ratios = np.asarray(ratios)
    ratio_chains = np.asarray(ratio_chains)
    lines = [f"draws: {len(fracs56)}"]
    lines.append(
        "l=5,6 power fraction: median %.3e  p90 %.3e  max %.3e"
        % (np.median(fracs56), np.quantile(fracs56, 0.9), fracs56.max())
    )
    lines.append(
        "P(l=5)/P(l=4) decay ratio: median %.3f  max %.3f"
        % (np.median(ratios), ratios.max())
    )
    lines.append(
        "l=7,8 power fraction (measured): median %.3e  p90 %.3e  max %.3e"
        % (np.median(fracs78), np.quantile(fracs78, 0.9), fracs78.max())
    )
    lines.append(
        "l=9,10 power fraction (measured): median %.3e  p90 %.3e  max %.3e"
        % (np.median(fracs910), np.quantile(fracs910, 0.9), fracs910.max())
    )
    if ratio_chains.size:
        med = np.median(ratio_chains, axis=0)
        lines.append("per-l decay ratios P(l+1)/P(l), l=5..9 medians: "
                     + str([round(float(v), 3) for v in med]))
    # geometric-tail bound on the l>10 remainder relative to total power
    r = float(np.quantile(ratio_chains[:, -1], 0.9)) if ratio_chains.size \
        else float(np.quantile(ratios, 0.9))
    tail_bound = float(np.quantile(fracs910, 0.9)) * r / max(1.0 - r, 1e-9)
    lines.append(f"geometric-tail bound on l>10 remainder: ~{tail_bound:.1e} of total power")

    report = {
        "draws": int(len(fracs56)),
        "l56_power_fraction": {
            "median": float(np.median(fracs56)),
            "p90": float(np.quantile(fracs56, 0.9)),
            "max": float(fracs56.max()),
        },
        "l5_over_l4_ratio_median": float(np.median(ratios)),
        "l78_power_fraction": {
            "median": float(np.median(fracs78)),
            "p90": float(np.quantile(fracs78, 0.9)),
            "max": float(fracs78.max()),
        },
        "l910_power_fraction": {
            "median": float(np.median(fracs910)),
            "p90": float(np.quantile(fracs910, 0.9)),
            "max": float(fracs910.max()),
        },
        "geometric_tail_bound_beyond_l10": tail_bound,
        "fd_mismatch_l4_vs_l6": [float(m) for m in mms],
        "fd_mismatch_l6_vs_l8": [float(m) for m in mms68],
        "fd_mismatch_l8_vs_l10": [float(m) for m in mms810],
    }
    return lines, report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    draws = 4 if args.quick else args.draws

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    table_hi = default_mode_table(20, l_max=10)
    sources = draw_sources(draws)
    p0s = solve_p0(sources[:, :3], T_DRAW * 1.02, device)
    powers = [
        power_by_l(m_mass, mu, float(p0), e0, th, ph, T_DRAW, table_hi, device=device)
        for (m_mass, mu, e0, th, ph), p0 in zip(sources, p0s)
    ]
    # the draws' lines first, as the original prints them before its cases
    lines, _ = report_of(powers, [], [], [])
    for line in lines:
        print(line)

    mms, mms68, mms810 = [], [], []
    case_p0 = solve_p0(np.asarray(CASES)[:, :3], T_CASE * 1.05, device)
    for (m_mass, mu, e0, th, ph), p0 in zip(CASES, case_p0):
        p0 = float(p0)
        mm = fd_mismatch_lpair(m_mass, mu, p0, e0, th, ph, T_CASE, l_pair=(4, 6), device=device)
        mm68 = fd_mismatch_lpair(m_mass, mu, p0, e0, th, ph, T_CASE, l_pair=(6, 8),
                                 device=device)
        mm810 = fd_mismatch_lpair(m_mass, mu, p0, e0, th, ph, T_CASE, l_pair=(8, 10),
                                  device=device)
        mms.append(mm)
        mms68.append(mm68)
        mms810.append(mm810)
        print(f"FD mismatch l4-l6 / l6-l8 / l8-l10 (M={m_mass:.0e}, mu={mu}, "
              f"e0={e0}): {mm:.3e} / {mm68:.3e} / {mm810:.3e}")

    _, report = report_of(powers, mms, mms68, mms810)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
