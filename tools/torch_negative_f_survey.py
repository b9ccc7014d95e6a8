"""Measure the mode power carried by negative-frequency harmonics, on the
PyTorch port.

The port's counterpart of ``tools/negative_f_survey.py``. The FD kernel
covers f_mn(t) < 0 ranges only when ``negative_slots > 0``. This survey
quantifies what that content is worth across the `check_mode_by_mode` draw
distribution: per draw, the mode set's power is split by the SIGN of f_mn
along the inspiral (a mode can cross zero mid-inspiral -- counted as
negative for the knots where it is), in the same dt-weighted power measure
the mode selector uses.

If the negative fraction is below the 1e-4 mismatch gate everywhere, the
production default ``negative_slots = 0`` is justified and this survey is
its documented bound.

The draws' p0 come from one batched duration solve (`get_p_at_t` over all
draws at once; each lane's p0 does not depend on its batch).

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    python -m tools.torch_negative_f_survey [--draws 32] [--device cpu]

``--per-draw`` prints each draw's p0, knot count and fraction; ``--save
FILE.npz`` keeps them with each draw's knots, and ``--knots FILE.npz``
evaluates the fraction again on the knots such a file holds (a run on
another device, or `tools/negative_f_draws.py`'s JAX run), so the two
devices' trajectories and their physics can be told apart; there it also
sums the amplitudes' float32 projections in float64
(`float64_products`), a yardstick for the float32 sums' order.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np

TH, PH = 0.7, 0.5


def draw_sources(draws: int, seed: int) -> np.ndarray:
    """(draws, 3) rows of (M, mu, e0) from the survey's prior, in the
    original's draw order."""
    from emri_frequencydomainwaveforms_tpu_torch.inference.prior import (
        ProbDistContainer,
        uniform_dist,
    )

    rng = np.random.default_rng(seed)
    priors = ProbDistContainer(
        {
            0: uniform_dist(np.log(5e5), np.log(4e6)),
            1: uniform_dist(np.log(1e-5), np.log(1e-4)),
            2: uniform_dist(0.1, 0.5),
        }
    )
    rows = []
    for _ in range(draws):
        lm, leta, e0 = np.asarray(priors.rvs(size=1, random_state=rng)).ravel()
        m_big = float(np.exp(lm))
        rows.append((m_big, float(np.exp(leta) * m_big), float(e0)))
    return np.asarray(rows)


def solve_p0(sources: np.ndarray, tobs: float, device) -> np.ndarray:
    """p0 of a 0.99 ``tobs``-yr inspiral for every row of ``sources``, in
    one batched duration solve."""
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import get_p_at_t

    p0 = get_p_at_t(sources[:, 0], sources[:, 1], sources[:, 2], 0.99 * tobs, device=device)
    return p0.cpu().numpy()


def source_knots(m_big, mu, p0, e0, tobs, device=None):
    """The live knots (p, e) of one source's ``tobs``-yr inspiral, (K,)
    float64 tensors on ``device``."""
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import schwarz_ecc_flux_inspiral

    traj = schwarz_ecc_flux_inspiral(m_big, mu, p0, float(e0), t_years=tobs, max_steps=512,
                                     device=device)
    n = int(traj.n[0])
    return traj.p[0, :n], traj.e[0, :n]


def negative_fraction(m_big, mu, p0, e0, tobs, table, rwz=True, device=None):
    """The negative-frequency share of one source's dt-weighted mode power
    along its ``tobs``-yr inspiral (`knot_negative_fraction` on its knots)."""
    return knot_negative_fraction(*source_knots(m_big, mu, p0, e0, tobs, device), table, rwz)


def knot_negative_fraction(p_k, e_k, table, rwz=True):
    """The negative-frequency share of the mode power summed over the
    live knots (p_k, e_k), (K,) float64 tensors."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import mode_amplitudes
    from emri_frequencydomainwaveforms_tpu_torch.models.geodesic import fundamental_frequencies
    from emri_frequencydomainwaveforms_tpu_torch.utils.ylm import spin_weighted_ylm

    amp_kw = dict(tail=True, factorized=True, rwz=True) if rwz else {}
    a_re, a_im = mode_amplitudes(p_k, e_k, table, **amp_kw)
    om_phi, om_r = fundamental_frequencies(p_k, e_k)
    th, ph = (torch.tensor(v, dtype=torch.float64, device=p_k.device) for v in (TH, PH))
    yp = spin_weighted_ylm(table.ls, table.ms, th, ph)
    ym = spin_weighted_ylm(table.ls, -table.ms, th, ph)
    # dt-weighted per-knot power, same measure as the selector
    pw_tot = (a_re**2 + a_im**2).cpu().numpy()  # (K, M)
    y2 = (yp[0] ** 2 + yp[1] ** 2 + ym[0] ** 2 + ym[1] ** 2).cpu().numpy()
    pw_tot = pw_tot * y2[None, :]
    om = (
        table.ms[None, :] * om_phi.cpu().numpy()[:, None]
        + table.ns[None, :] * om_r.cpu().numpy()[:, None]
    )
    neg = om < 0.0
    return float(np.sum(pw_tot[neg]) / np.sum(pw_tot))


@contextlib.contextmanager
def float64_products():
    """The amplitudes' projections (`models.amplitude._products`) summed in
    float64 for the duration, their inputs and outputs still float32: a
    yardstick for the float32 products' accumulation order, which carries
    the weak (negative-frequency) harmonics' power."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude

    products = amplitude._products
    amplitude._products = lambda a, w: torch.matmul(a.double(), w.double()).float()
    try:
        yield
    finally:
        amplitude._products = products


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--tobs", type=float, default=1.0)
    ap.add_argument("--eps", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=2601996)
    ap.add_argument("--rwz", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--per-draw", action="store_true",
                    help="print each draw's p0, knot count and fraction")
    ap.add_argument("--save", default=None,
                    help="npz file for the draws, p0, knots and fractions")
    ap.add_argument("--knots", default=None,
                    help="npz file (--save's layout) whose knots are evaluated again here "
                         "(implies --per-draw)")
    args = ap.parse_args(argv)

    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    table = default_mode_table(30)
    sources = draw_sources(args.draws, args.seed)
    p0s = solve_p0(sources, args.tobs, device)

    carried = np.load(args.knots) if args.knots else None
    fracs, worst, n_knots, knots, kept = [], None, [], [], []
    for i, ((m_big, mu, e0), p0) in enumerate(zip(sources, p0s)):
        if not np.isfinite(p0):
            continue
        p_k, e_k = source_knots(m_big, mu, float(p0), e0, args.tobs, device)
        frac = knot_negative_fraction(p_k, e_k, table, args.rwz)
        fracs.append(frac)
        n_knots.append(len(p_k))
        knots.append((p_k.cpu().numpy(), e_k.cpu().numpy()))
        kept.append(i)
        if worst is None or frac > worst[0]:
            worst = (frac, m_big, mu, float(p0), float(e0))
        if args.per_draw or carried is not None:
            line = (f"draw {i}: M={m_big:.6e} mu={mu:.4f} e0={e0:.6f} p0={p0:.12f} "
                    f"knots={len(p_k)} frac={frac:.6e}")
            if carried is not None:
                j = list(carried["draw"]).index(i)
                n_c = int(carried["n_knots"][j])
                p_c, e_c = (torch.as_tensor(carried[k][j, :n_c], device=device)
                            for k in ("p_knots", "e_knots"))
                frac_c = knot_negative_fraction(p_c, e_c, table, args.rwz)
                with float64_products():
                    frac_64 = knot_negative_fraction(p_c, e_c, table, args.rwz)
                ref = float(carried["fracs"][j])
                line += (f" | carried: p0={float(carried['p0'][i]):.12f} knots={n_c} "
                         f"frac={ref:.6e}, here on its knots {frac_c:.6e} "
                         f"(rel {abs(frac_c / ref - 1.0):.2e}), with float64 products "
                         f"{frac_64:.6e} (carried rel {abs(ref / frac_64 - 1.0):.2e}, here "
                         f"{abs(frac_c / frac_64 - 1.0):.2e})")
            print(line, flush=True)
    if args.save:
        pad = max(n_knots)
        p_knots, e_knots = (np.full((len(knots), pad), np.nan) for _ in range(2))
        for i, (p_k, e_k) in enumerate(knots):
            p_knots[i, : len(p_k)], e_knots[i, : len(e_k)] = p_k, e_k
        np.savez(args.save, sources=sources, p0=p0s, draw=np.asarray(kept),
                 n_knots=np.asarray(n_knots),
                 fracs=np.asarray(fracs), p_knots=p_knots, e_knots=e_knots)

    fracs = np.asarray(fracs)
    print(
        f"draws={len(fracs)}  negative-f power fraction: "
        f"median {np.median(fracs):.3e}  p95 {np.percentile(fracs, 95):.3e}"
        f"  max {fracs.max():.3e}"
    )
    print(
        "worst draw: frac %.3e at M=%.3e mu=%.2f p0=%.3f e0=%.3f"
        % worst
    )
    print(
        "gate context: FD/TD mismatch budget 1e-4; a negative-f power "
        "fraction f contributes O(f) mismatch if dropped."
    )
    return dict(fracs=fracs, p0=p0s, worst=worst, n_knots=n_knots)


if __name__ == "__main__":
    main()
