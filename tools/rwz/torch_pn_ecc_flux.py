"""Small-eccentricity PN expansion of the RWZ total flux (external anchor),
on the PyTorch port.

The port's counterpart of ``tools/rwz/pn_ecc_flux.py``: it measures, from
the first-principles eccentric RWZ solver (tools/rwz/eccentric.py), the
small-e expansion of the orbit-averaged total energy flux at fixed
azimuthal frequency,

    F(v, e) / F(v, 0) = 1 + e^2 G(v) + O(e^4),
    G(v) = g0 + g2 v^2 + g3 v^3 + O(v^4),      v = (M Omega_phi)^(1/3),

with e the Darwin (geodesic) eccentricity at fixed Omega_phi, and with
``--model`` / ``--model-only`` the same coefficients of the port's model
stack (tail + factorized, f64 projection: `torch_calibrate_ecc.
model_amplitudes_f64` on the chosen torch device). The Newtonian
coefficient is exact and convention-free (Peters-Mathews re-expanded at
fixed azimuthal frequency): g0 = 7/2 + 73/24 = 157/24. g2 and g3 are
convention-dependent at 1PN and reported as measured values of this
convention.

Method: for each circular frequency v (p_circ = v^-2), root-find p(e)
such that Omega_phi(p, e) = v^3 (Darwin orbit), sum the per-mode RWZ
fluxes over l <= 4, |n| <= 3 (higher n enters at O(e^{2|n|-2}) relative),
fit the e^2 slope from the e-points, then fit G(v) = g0 + g2 v^2 + g3 v^3
(+ g4 v^4) over the v mesh. The solver side and the fits are copies of the
original's numpy code.

Run:  python -m tools.rwz.torch_pn_ecc_flux [--quick] [--model] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .eccentric import darwin_orbit, eccentric_flux_mode

G0_EXACT = 157.0 / 24.0
G2_PUBLISHED = -6781.0 / 168.0
G3_PUBLISHED = (2335.0 / 48.0) * np.pi


def omega_phi(p: float, e: float, n_chi: int = 256) -> float:
    return darwin_orbit(p, e, n_chi)["Om_phi"]


def p_at_fixed_omega(om_target: float, e: float) -> float:
    """Darwin p with Omega_phi(p, e) = om_target (Newton iteration)."""
    p = om_target ** (-2.0 / 3.0)  # circular/Keplerian seed
    for _ in range(60):
        f0 = omega_phi(p, e) - om_target
        dp = max(1e-6 * p, 1e-8)
        d = (omega_phi(p + dp, e) - omega_phi(p - dp, e)) / (2.0 * dp)
        step = f0 / d
        p -= step
        if abs(step) < 1e-12 * p:
            break
    return p


def total_flux(p: float, e: float, l_max: int = 4, n_abs: int = 3,
               n_chi: int = 512) -> float:
    """Sum of per-mode RWZ fluxes (mu = M = 1): m > 0 doubled by the
    equatorial symmetry F(l,-m,-n) = F(l,m,n); m = 0 summed over both n
    signs explicitly."""
    orb = darwin_orbit(p, e, n_chi)
    tot = 0.0
    for l in range(2, l_max + 1):
        for m in range(0, l + 1):
            for n in range(-n_abs, n_abs + 1):
                if m == 0 and n <= 0:
                    continue  # n<0 partner added via weight below
                om = m * orb["Om_phi"] + n * orb["Om_r"]
                if abs(om) < 1e-8:
                    continue
                f, _ = eccentric_flux_mode(l, m, n, p, e, _orbit=orb)
                tot += 2.0 * f  # +-m partners (m>0); +-n partners (m=0)
    return tot


def g_of_v(p_circ: float, es=(0.004, 0.04, 0.08, 0.12), l_max: int = 4,
           n_chi: int = 512, n_abs: int = 4, verbose: bool = True):
    """e^2 slope of F/F(e->0) at fixed Omega_phi = p_circ^{-3/2}.

    Four e-values with an e^6 fit term: the quadratic-in-e^2 fit's
    e^6-truncation biases G by ~1e-3 at e_max ~ 0.1 (measured against
    the exact fixed-frequency Peters-Mathews expansion, whose e^6
    coefficient is ~40); the cubic fit pushes that to ~1e-5.
    """
    om = p_circ ** (-1.5)
    fs = []
    for e in es:
        p = p_at_fixed_omega(om, e)
        fs.append(total_flux(p, e, l_max=l_max, n_abs=n_abs, n_chi=n_chi))
        if verbose:
            print(f"    e={e:.3f}: p={p:.6f}  F={fs[-1]:.9e}", flush=True)
    e2 = np.asarray(es) ** 2
    A = np.stack([e2**k for k in range(len(es))], axis=1)
    coef = np.linalg.solve(A, np.asarray(fs))
    return coef[1] / coef[0]


def model_total_flux(p: float, e: float, device=None) -> float:
    """Total flux of the MODEL stack (tail + factorized; the rwz residual
    is excluded so this measures the model the calibration corrects).

    Uses the f64 baseline projection (`torch_calibrate_ecc.
    model_amplitudes_f64` on ``device``); the production f32 path's ~1e-7
    amplitude noise is far too loud for the 1e-4-relative small-e slope
    extraction. Cheap: no ODE solves.
    """
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table

    from .torch_calibrate_ecc import model_amplitudes_f64

    table = default_mode_table(8, l_max=4)
    tls, tms, tns = table.ls, table.ms, table.ns
    orb = darwin_orbit(float(p), float(e), 512)
    a = model_amplitudes_f64(float(p), float(e), orb, table, tls, tms, tns, device=device)
    om_all = tms * orb["Om_phi"] + tns * orb["Om_r"]
    return float(np.sum(om_all**2 * np.abs(a) ** 2) / (8.0 * np.pi))


def g_of_v_model(p_circ: float, es=(0.004, 0.04, 0.08, 0.12), device=None):
    om = p_circ ** (-1.5)
    fs = []
    for e in es:
        p = p_at_fixed_omega(om, e)
        fs.append(model_total_flux(p, e, device))
    e2 = np.asarray(es) ** 2
    A = np.stack([e2**k for k in range(len(es))], axis=1)
    coef = np.linalg.solve(A, np.asarray(fs))
    return coef[1] / coef[0]


def fit_g_series(ps, gs, n_terms: int = 4):
    """Fit G(v) = g0 + g2 v^2 + g3 v^3 (+ g4 v^4 + g5 v^5)."""
    v = np.asarray(ps) ** -0.5
    pows = [np.ones_like(v), v**2, v**3, v**4, v**5][:n_terms]
    A = np.stack(pows, axis=1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(gs), rcond=None)
    resid = np.max(np.abs(A @ coef - gs))
    return coef, resid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="2 v-points, g0 only (CI smoke)")
    ap.add_argument("--model", action="store_true",
                    help="ALSO extract the production model stack's G(v) "
                         "coefficients (cheap) for comparison")
    ap.add_argument("--model-only", action="store_true",
                    help="skip the solver extraction entirely")
    ap.add_argument("--deep", action="store_true",
                    help="7 v-points out to p=1800 + v^5 fit term (snaps "
                         "g2 to ~1e-4)")
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = None
    if args.model or args.model_only:
        from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

        device = resolve_device(args.device)

    t0 = time.time()
    if args.quick:
        ps = [60.0, 120.0]
    elif args.deep:
        ps = [60.0, 100.0, 180.0, 320.0, 560.0, 1000.0, 1800.0]
    else:
        ps = [60.0, 100.0, 180.0, 320.0, 560.0]
    n_terms = 5 if args.deep else 4
    if args.model_only:
        gm = [g_of_v_model(p, device=device) for p in ps]
        coef_m, resid_m = fit_g_series(ps, gm, n_terms=n_terms)
        print(f"model stack (tail+factorized, f64 projection, no ecc "
              f"residual), fit residual {resid_m:.2e}:")
        print(f"  g0_model = {coef_m[0]:+.6f}   diff vs exact 157/24 "
              f"{coef_m[0] - G0_EXACT:+.2e}")
        print(f"  g2_model = {coef_m[1]:+.6f}")
        print(f"  g3_model = {coef_m[2]:+.6f}")
        return

    gs = []
    for p_circ in ps:
        print(f"p_circ={p_circ}:", flush=True)
        g = g_of_v(p_circ, l_max=args.lmax)
        gs.append(g)
        print(f"  G(v) = {g:.8f}   ({time.time() - t0:.0f}s)", flush=True)

    v = np.asarray(ps) ** -0.5
    gs = np.asarray(gs)
    if args.quick:
        # linear-in-v^2 extrapolation to v = 0 -> g0 only
        g0 = (gs[0] * v[1] ** 2 - gs[1] * v[0] ** 2) / (v[1] ** 2 - v[0] ** 2)
        print(f"g0 = {g0:.6f}  (exact 157/24 = {G0_EXACT:.6f}, "
              f"diff {g0 - G0_EXACT:+.2e})")
        return

    coef, resid = fit_g_series(ps, gs, n_terms=n_terms)
    g0, g2, g3 = coef[0], coef[1], coef[2]
    print(f"\nfit G(v) over p_circ = {ps} ({n_terms} terms, "
          f"max fit residual {resid:.2e})")
    print(f"  g0 = {g0:+.6f}   exact 157/24 = {G0_EXACT:+.6f}   "
          f"diff {g0 - G0_EXACT:+.2e}")
    print(f"  g2 = {g2:+.6f}   (MEASURED, Darwin-e @ fixed Omega_phi "
          "convention; deep-run value -16.09 +- ~0.05)")
    print(f"  g3 = {g3:+.6f}")
    print("  NOTE: g2/g3 are CONVENTION-DEPENDENT (the e and v definitions "
          "at 1PN differ between the Darwin parametrization used here and "
          "the PN-literature e_t / r0-based series, e.g. the familiar "
          f"-6781/168 = {G2_PUBLISHED:+.4f}); only g0 is "
          "convention-free and is pinned EXACTLY by Peters-Mathews.")

    if args.model:
        gm = [g_of_v_model(p, device=device) for p in ps]
        coef_m, resid_m = fit_g_series(ps, gm, n_terms=n_terms)
        print(f"\nmodel stack (tail+factorized, no ecc residual), "
              f"same convention (fit residual {resid_m:.2e}):")
        print(f"  g0_model = {coef_m[0]:+.6f}   diff vs exact "
              f"{coef_m[0] - G0_EXACT:+.2e}")
        print(f"  g2_model = {coef_m[1]:+.6f}   diff vs solver "
              f"{coef_m[1] - g2:+.4f}")
        print(f"  g3_model = {coef_m[2]:+.6f}   diff vs solver "
              f"{coef_m[2] - g3:+.4f}")


if __name__ == "__main__":
    sys.exit(main())
