"""The negative-frequency survey's draws one by one, on the JAX package.

``tools/negative_f_survey.py`` prints only the survey's statistics. This
runs the same draws through the same JAX computation and prints, per draw,
the p0 of its own duration solve, the knot count of its trajectory and its
negative-frequency power fraction, in the layout of
``tools/torch_negative_f_survey.py --per-draw``. ``--save FILE.npz`` keeps
them with the knots (that twin's ``--knots`` reads the file), and
``--knots FILE.npz`` evaluates the fraction again on the knots of a file
the twin wrote on another device, so a difference between two devices'
survey statistics can be split into their trajectories (p0, knots) and
their physics on one set of knots.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/negative_f_draws.py --draws 24 \\
        [--save jax.npz] [--knots card.npz]
"""

from __future__ import annotations

import argparse

import numpy as np

TH, PH = 0.7, 0.5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--tobs", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=2601996)
    ap.add_argument("--save", default=None)
    ap.add_argument("--knots", default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.inference.prior import ProbDistContainer, uniform_dist
    from emri_frequencydomainwaveforms_tpu.models.amplitude import (
        default_mode_table,
        mode_amplitudes,
    )
    from emri_frequencydomainwaveforms_tpu.models.geodesic import fundamental_frequencies
    from emri_frequencydomainwaveforms_tpu.models.inspiral import (
        get_p_at_t,
        schwarz_ecc_flux_inspiral,
    )
    from emri_frequencydomainwaveforms_tpu.utils.ylm import spin_weighted_ylm

    table = default_mode_table(30)
    yp = spin_weighted_ylm(table.ls, table.ms, TH, PH)
    ym = spin_weighted_ylm(table.ls, -table.ms, TH, PH)
    y2 = sum(np.asarray(c) ** 2 for c in (*yp, *ym))

    def fraction(p_k, e_k):
        # tools/negative_f_survey.py's per-draw computation
        a_re, a_im = mode_amplitudes(jnp.asarray(p_k), jnp.asarray(e_k), table,
                                     tail=True, factorized=True, rwz=True)
        om_phi, om_r = fundamental_frequencies(jnp.asarray(p_k), jnp.asarray(e_k))
        pw = (np.asarray(a_re) ** 2 + np.asarray(a_im) ** 2) * y2[None, :]
        om = (table.ms[None, :] * np.asarray(om_phi)[:, None]
              + table.ns[None, :] * np.asarray(om_r)[:, None])
        return float(np.sum(pw[om < 0.0]) / np.sum(pw))

    rng = np.random.default_rng(args.seed)
    priors = ProbDistContainer({
        0: uniform_dist(np.log(5e5), np.log(4e6)),
        1: uniform_dist(np.log(1e-5), np.log(1e-4)),
        2: uniform_dist(0.1, 0.5),
    })
    carried = np.load(args.knots) if args.knots else None
    sources, p0s, n_knots, fracs, knots, kept = [], [], [], [], [], []
    for i in range(args.draws):
        lm, leta, e0 = np.asarray(priors.rvs(size=1, random_state=rng)).ravel()
        m_big = float(np.exp(lm))
        mu = float(np.exp(leta) * m_big)
        sources.append((m_big, mu, float(e0)))
        p0 = float(get_p_at_t(m_big, mu, e0, 0.99 * args.tobs))
        p0s.append(p0)
        traj = schwarz_ecc_flux_inspiral(m_big, mu, p0, float(e0), t_years=args.tobs,
                                         max_steps=512)
        n = int(traj.n)
        p_k, e_k = np.asarray(traj.p)[:n], np.asarray(traj.e)[:n]
        frac = fraction(p_k, e_k)
        n_knots.append(n)
        fracs.append(frac)
        knots.append((p_k, e_k))
        kept.append(i)
        line = (f"draw {i}: M={m_big:.6e} mu={mu:.4f} e0={e0:.6f} p0={p0:.12f} "
                f"knots={n} frac={frac:.6e}")
        if carried is not None:
            j = list(carried["draw"]).index(i)
            n_c = int(carried["n_knots"][j])
            frac_c = fraction(carried["p_knots"][j, :n_c], carried["e_knots"][j, :n_c])
            ref = float(carried["fracs"][j])
            line += (f" | carried: p0={float(carried['p0'][i]):.12f} knots={n_c} "
                     f"frac={ref:.6e}, here on its knots {frac_c:.6e} "
                     f"(rel {abs(frac_c / ref - 1.0):.2e})")
        print(line, flush=True)
    fracs = np.asarray(fracs)
    print(f"draws={len(fracs)}  negative-f power fraction: median {np.median(fracs):.3e}  "
          f"p95 {np.percentile(fracs, 95):.3e}  max {fracs.max():.3e}")
    if args.save:
        pad = max(n_knots)
        p_knots, e_knots = (np.full((len(knots), pad), np.nan) for _ in range(2))
        for j, (p_k, e_k) in enumerate(knots):
            p_knots[j, : len(p_k)], e_knots[j, : len(e_k)] = p_k, e_k
        np.savez(args.save, sources=np.asarray(sources), p0=np.asarray(p0s),
                 draw=np.asarray(kept), n_knots=np.asarray(n_knots), fracs=fracs,
                 p_knots=p_knots, e_knots=e_knots)
    return dict(fracs=fracs, p0=np.asarray(p0s), n_knots=n_knots)


if __name__ == "__main__":
    main()
