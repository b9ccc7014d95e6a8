"""Generate the eccentric strong-field calibration table, on the PyTorch port.

The port's counterpart of ``tools/rwz/calibrate_ecc.py``. For every
production amplitude mode (l, m, n) (l <= --lmax, n in [N_LO, N_HI]) it
computes, on the package's regular (u, e) orbit grid
(u = log(p - p_sep + _U_SHIFT), the amplitude/flux-grid convention), the
COMPLEX residual ratio

    R_lmn(u, e) = A_RWZ_lmn / (A_model_lmn B_lm(x_mn)),

where A_RWZ is the first-principles eccentric RWZ amplitude
(tools/rwz/eccentric.py) mapped to the package's amplitude units via the
flux normalization (even parity: sqrt(8 pi N_l) C / 2; odd:
sqrt(8 pi N_l) C / omega; N_l = (l+2)!/((l-2)! 8 pi)) and A_model is the
port's per-mode amplitude with tail + factorized applied, projected in
float64 (`model_amplitudes_f64`, on the chosen torch device) over the same
Darwin orbit the RWZ solve uses. The eccentric residual itself is excluded
from the baseline, so re-running this generator is a fixed point.

Modes with |omega_mn| < OMEGA_MIN at a grid node keep R = 1 there; modes
the solver cannot calibrate are omitted from the table entirely (R = 1
fallback at application time). The raw solve is kept beside the table
(``*_raw.npz`` under tools/rwz/), and ``--from-raw`` re-cleans such a file
without solving. The cleaning (`clean_table`), the writer (`write_table`)
and their helpers are copies of the original's numpy code.

Writes ``emri_frequencydomainwaveforms_tpu_torch/models/_rwz_ecc_data.py``
unless ``--out`` names another file.

Run:  python -m tools.rwz.torch_calibrate_ecc [--lmax 4] [--nu 10] [--ne 6]
      [--out <path>] [--families "2,2 3,3"] [--device cpu]

Single-core cost at the defaults: ~2400 homogeneous-solution pairs
(~0.25 s each) per 10 grid columns; progress prints per grid node.
"""

from __future__ import annotations

import argparse
import sys
import time
from math import factorial as _fac

import numpy as np

OMEGA_MIN = 2e-3
N_LO, N_HI = -2, 12

# robust-cleaning tolerances (the original's): a node is an outlier when
# its modulus deviates from the local (3x3 calibrated-neighbor) median by
# more than MAG_TOL x, or its phase from the circular neighbor mean by
# PH_TOL rad; with per-node measured error bars a node is rejected only
# when its OWN quadrature error exceeds ERR_REJECT.
MAG_TOL = 1.35
PH_TOL = 0.35
ERR_REJECT = 5e-3

OUT = "emri_frequencydomainwaveforms_tpu_torch/models/_rwz_ecc_data.py"


def model_amplitudes_f64(p, e, orb, table, tls, tms, tns, device=None):
    """f64 baseline A_lmn (tail + factorized, NO rwz), numpy complex (M,).

    A_lmn = C_lm omega_mn^l F_n[g_lm], with F_n an f64 spectral projection
    over the Darwin orbit ``orb`` (the RWZ solver's `eccentric.darwin_orbit`
    dict), then the tail and factorized corrections as `mode_amplitudes`
    applies them. The projection runs on ``device`` (default: the current
    CUDA device), all modes at once.
    """
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import _FAMILIES
    from emri_frequencydomainwaveforms_tpu_torch.models.rho import factorized_correction
    from emri_frequencydomainwaveforms_tpu_torch.models.tail import tail_factor
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def on(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    chi = orb["chi"]
    n_chi = len(chi)
    h = 2.0 * np.pi / n_chi
    om_phi, om_r = float(orb["Om_phi"]), float(orb["Om_r"])
    r, t, chi_t = on(orb["r"]), on(orb["t"]), on(chi)
    dphi = on(orb["phi"]) - om_phi * t
    theta = om_r * t
    w = on(orb["dt_dchi"]) * (h / float(orb["T_r"]))
    ecos = e * torch.cos(chi_t)
    dphi_dchi = torch.sqrt(p / (p - 6.0 - 2.0 * ecos))
    ell = r * r * dphi_dchi / on(orb["dt_dchi"])

    # modes of no known family keep A = 0 (C = 0 below)
    fams = [_FAMILIES.get((int(l), int(m))) for l, m in zip(tls, tms)]
    keys = sorted({f[:3] for f in fams if f is not None})
    gs = torch.stack([
        (r**rp) * (ell if lp else torch.ones_like(r)) * torch.exp(1j * k * dphi)
        for k, rp, lp in keys
    ])  # (G, n_chi) complex128
    rows = np.array([keys.index(f[:3]) if f is not None else 0 for f in fams])
    c = np.array([complex(f[3], f[4]) if f is not None else 0j for f in fams])
    ns = on(tns)
    g = gs[torch.as_tensor(rows, device=dev)]
    f_n = torch.sum(w * g * torch.exp(-1j * ns[:, None] * theta), dim=-1).real
    om = on(tms) * om_phi + ns * om_r
    out = torch.as_tensor(c, device=dev) * om ** on(tls) * f_n

    t_re, t_im = tail_factor(np.asarray(tls), om)
    c2_re, c2_im = factorized_correction(np.asarray(tls), np.asarray(tms), on(float(p)),
                                         on(float(e)), om)
    corr = torch.complex(t_re, t_im) * torch.complex(c2_re, c2_im)
    return (out * corr).cpu().numpy()


def circular_correction(tls, tms, om_all, device=None):
    """B_lm(x_mn) per mode (the port's `rwz_correction`), numpy."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.rho import _x_of_mode
    from emri_frequencydomainwaveforms_tpu_torch.models.rwz_calibration import rwz_correction
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    om = torch.as_tensor(np.asarray(om_all, dtype=np.float64), device=resolve_device(device))
    return rwz_correction(tls, tms, _x_of_mode(om, tms)).cpu().numpy()


def rwz_units(l, m, c_rwz, om):
    """The RWZ amplitude C in the package's amplitude units."""
    norm = np.sqrt(8.0 * np.pi * _fac(l + 2) / _fac(l - 2) / (8.0 * np.pi))
    return norm * c_rwz / 2.0 if (l + m) % 2 == 0 else norm * c_rwz / om


def grid_axes(nu, ne, e_max):
    """The (u, e) grid's nodes."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends import _U_SHIFT

    us = np.linspace(np.log(_U_SHIFT + 0.05), np.log(16.0), nu)
    es = np.linspace(0.05, e_max, ne)
    return us, es


def p_of_node(u, e):
    """Semi-latus rectum of the orbit at grid coordinates (u, e)."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends import _U_SHIFT

    return float(np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e)


def mode_index(table, fams, ns):
    """{(l, m, n): row of ``table``} for the families and harmonics asked."""
    tls, tms, tns = table.ls, table.ms, table.ns
    out = {}
    for (l, m) in fams:
        for n in ns:
            hit = np.where((tls == l) & (tms == m) & (tns == n))[0]
            if len(hit):
                out[(l, m, n)] = int(hit[0])
    return out


def baseline(p, e, orb, table, device=None):
    """The model side at one orbit: (A_model B_lm per mode, omega_mn per
    mode), numpy."""
    tls, tms, tns = table.ls, table.ms, table.ns
    a_base = model_amplitudes_f64(p, e, orb, table, tls, tms, tns, device=device)
    om_all = tms * orb["Om_phi"] + tns * orb["Om_r"]
    return a_base * circular_correction(tls, tms, om_all, device), om_all


def _skip_line(key, p, e, exc):
    l, m, n = key
    return f"  skip ({l},{m},{n}) @ ({p:.3f},{e:.2f}): {exc}"


def calibrate_node(p, e, n_chi, table, mode_idx, keys=None, device=None, skip_line=_skip_line):
    """R and its relative quadrature error for the modes ``keys`` (default
    every mode of ``mode_idx``) at one orbit: {(l, m, n): (R, err)}; modes
    under the frequency or amplitude floor, solver failures (reported by
    ``skip_line``) and degenerate ratios are left out."""
    from .eccentric import darwin_orbit, eccentric_amplitude

    orb = darwin_orbit(p, e, n_chi)
    a_base, _ = baseline(p, e, orb, table, device)
    a_floor = 1e-8 * float(np.max(np.abs(a_base)))
    out = {}
    for key in (mode_idx if keys is None else keys):
        l, m, n = key
        om = m * orb["Om_phi"] + n * orb["Om_r"]
        a_model = complex(a_base[mode_idx[key]])
        if abs(om) < OMEGA_MIN or abs(a_model) < a_floor:
            continue
        try:
            c_rwz, _, c_coarse = eccentric_amplitude(
                l, m, n, p, e, _orbit=orb, return_coarse=True
            )
        except RuntimeError as exc:  # Wronskian drift etc.
            print(skip_line(key, p, e, exc), flush=True)
            continue
        r = rwz_units(l, m, c_rwz, om) / a_model
        if not np.isfinite(r) or not 0.2 < abs(r) < 5.0:
            # degenerate ratio (near-null model mode / tiny omega):
            # leave R = 1 rather than poison the table
            continue
        out[key] = (r, float(abs(c_rwz - c_coarse) / max(abs(c_rwz), 1e-300)))
    return out


def raw_path_for(out):
    """The raw sidecar's path for a table written to ``out``."""
    return out.replace(".py", "_raw.npz").replace(
        "emri_frequencydomainwaveforms_tpu_torch/models/", "tools/rwz/")


def load_raw(path):
    """(rows, errs, grid) of a raw npz sidecar."""
    dat = np.load(path)
    keys = [tuple(int(v) for v in k) for k in dat["keys"]]
    rows = {k: dat["rows"][i] for i, k in enumerate(keys)}
    errs = {k: dat["errs"][i] for i, k in enumerate(keys)}
    return rows, errs, dat["grid"]


def from_raw(path, out):
    """Re-clean a raw npz sidecar and write the table to ``out``."""
    rows, errs, grid = load_raw(path)
    u0, du, e0, de, nu, ne = grid
    rows, errs = clean_table(rows, errs)
    _err_summary(rows, errs)
    write_table(out, rows, u0, du, e0, de, int(nu), int(ne), errs=errs)
    return rows, errs


def _calibrated_neighbors(logmag, ph, calib, i, j):
    nu, ne = calib.shape
    out = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            a, b = i + di, j + dj
            if 0 <= a < nu and 0 <= b < ne and calib[a, b]:
                out.append((logmag[a, b], ph[a, b]))
    return out


def clean_table(rows, errs=None):
    """Robust post-pass on the raw residual grids.

    The eccentric solver occasionally glitches at isolated grid nodes
    (Wronskian drift, quadrature resonance): a 1.5-5x modulus spike or a
    ~pi phase flip sitting inside an otherwise smooth field. Those are
    numerical, not physics, and they poison the bilinear interpolation
    (and the 'bounded correction' contract) around the node. Three
    stages, all deterministic:

      1-2. outlier rejection (two sweeps, batch-detected then batch-
           replaced): any calibrated node deviating from its calibrated
           3x3 neighborhood median modulus by > MAG_TOL x or from the
           circular-mean phase by > PH_TOL rad is replaced by that
           neighborhood reference; isolated calibrated nodes (< 2
           calibrated neighbors) revert to R = 1.
      3.   smooth fill: uncalibrated nodes (R = 1 holes from the
           omega/amplitude floors) adjacent to >= 2 calibrated nodes are
           filled with the neighborhood reference, iterated to fixed
           point. The model amplitude at such nodes is negligible (that
           is WHY they were skipped), so the fill only removes bilinear
           cliffs — it cannot change any retained mode's physics.
      4.   shrinkage toward the 3x3-median smooth field. With measured
           per-node quadrature-error estimates (``errs``; generated with
           the table — tools/rwz/eccentric.py
           ``return_coarse``) each node keeps S + beta_ij (F - S) with
           beta_ij = sig2 / (sig2 + err_ij^2), sig2 = max(var(F - S) -
           mean(err^2), 0) the empirical real-structure variance: nodes
           whose deviation from the smooth field is resolved (err small)
           keep it in full, noise-dominated nodes revert to the smooth
           field — and the smooth field itself is NEVER shrunk (the old
           blanket Wiener stage discarded real low-amplitude structure
           by shrinking S toward identity).
           Without error estimates (legacy tables) the old blanket
           Wiener shrink applies unchanged.

    Returns ``(rows, errs)`` — cleaned residual grids plus the
    per-node relative error grids (replaced/filled nodes inherit their
    calibrated neighborhood's median error; empty dict when ``errs`` is
    None).
    """
    out = {}
    out_err = {}
    for key, r0 in rows.items():
        err = None if errs is None else np.array(errs[key], dtype=float)
        r = np.array(r0, dtype=complex)
        nu, ne = r.shape
        calib = np.abs(r - 1.0) > 1e-12
        for _ in range(2):
            logmag = np.log(np.abs(r))
            ph = np.angle(r)
            repl = {}
            for i in range(nu):
                for j in range(ne):
                    if not calib[i, j]:
                        continue
                    # with measured error bars, a node is a
                    # glitch ONLY if its own quadrature error says so —
                    # smoothness-based rejection demonstrably replaced
                    # REAL structure measured to 1e-14 (high-e edge of
                    # (3,3,1); held-out check). Legacy tables without
                    # error bars keep the neighborhood-deviation test.
                    if err is not None:
                        if err[i, j] > ERR_REJECT:
                            vals = _calibrated_neighbors(
                                logmag, ph, calib, i, j)
                            if len(vals) < 2:
                                repl[(i, j)] = None
                            else:
                                lm = float(np.median([v[0] for v in vals]))
                                lp = float(np.angle(np.mean(
                                    [np.exp(1j * v[1]) for v in vals])))
                                repl[(i, j)] = np.exp(lm + 1j * lp)
                        continue
                    vals = _calibrated_neighbors(logmag, ph, calib, i, j)
                    if len(vals) < 2:
                        repl[(i, j)] = None
                        continue
                    lm = float(np.median([v[0] for v in vals]))
                    lp = float(np.angle(np.mean(
                        [np.exp(1j * v[1]) for v in vals])))
                    dph = float(np.angle(np.exp(1j * (ph[i, j] - lp))))
                    if (abs(logmag[i, j] - lm) > np.log(MAG_TOL)
                            or abs(dph) > PH_TOL):
                        repl[(i, j)] = np.exp(lm + 1j * lp)
            for (i, j), v in repl.items():
                if v is None:
                    r[i, j] = 1.0
                    calib[i, j] = False
                    if err is not None:
                        err[i, j] = 0.0
                else:
                    r[i, j] = v
                    if err is not None:
                        err[i, j] = _neighbor_err(err, calib, i, j)
        for _ in range(nu + ne):
            logmag = np.log(np.abs(r))
            ph = np.angle(r)
            fills = {}
            for i in range(nu):
                for j in range(ne):
                    if calib[i, j]:
                        continue
                    vals = _calibrated_neighbors(logmag, ph, calib, i, j)
                    if len(vals) >= 2:
                        lm = float(np.median([v[0] for v in vals]))
                        lp = float(np.angle(np.mean(
                            [np.exp(1j * v[1]) for v in vals])))
                        fills[(i, j)] = np.exp(lm + 1j * lp)
            if not fills:
                break
            for (i, j), v in fills.items():
                r[i, j] = v
                calib[i, j] = True
                if err is not None:
                    err[i, j] = _neighbor_err(err, calib, i, j)
        if calib.any():
            r = _noise_shrink(r, err) if err is not None else _wiener_shrink(r)
        out[key] = r
        if err is not None:
            out_err[key] = err
    return out, out_err


def _neighbor_err(err, calib, i, j):
    """Median error of the calibrated 3x3 neighbors (for replaced/filled
    nodes whose own measured error no longer applies)."""
    nu, ne = err.shape
    vals = [
        err[a, b]
        for a in range(max(i - 1, 0), min(i + 2, nu))
        for b in range(max(j - 1, 0), min(j + 2, ne))
        if (a, b) != (i, j) and calib[a, b]
    ]
    return float(np.median(vals)) if vals else float(np.max(err))


def _noise_shrink(r, err):
    """Stage 4 of clean_table with measured per-node errors (docstring).

    ``err`` is the relative complex quadrature-error estimate per node —
    it bounds both the log-modulus and the phase error of R (for small
    err: |dlog|R|| <= err, |darg R| <= err), so the same noise field
    drives both components' shrinkage.
    """
    out_fields = []
    e2 = err * err
    for field in (np.log(np.abs(r)), np.angle(r)):
        smooth = _medfilt3(field)
        resid = field - smooth
        sig2 = max(float(np.mean(resid**2)) - float(np.mean(e2)), 0.0)
        beta = sig2 / (sig2 + e2 + 1e-300)
        out_fields.append(smooth + beta * resid)
    return np.exp(out_fields[0] + 1j * out_fields[1])


def _medfilt3(field):
    nu, ne = field.shape
    out = np.empty_like(field)
    for i in range(nu):
        for j in range(ne):
            lo_i, hi_i = max(i - 1, 0), min(i + 2, nu)
            lo_j, hi_j = max(j - 1, 0), min(j + 2, ne)
            out[i, j] = np.median(field[lo_i:hi_i, lo_j:hi_j])
    return out


def _wiener_shrink(r):
    """Stage 4 of clean_table (see its docstring)."""
    parts = []
    for field in (np.log(np.abs(r)), np.angle(r)):
        smooth = _medfilt3(field)
        var_s = float(np.mean(smooth**2))
        var_n = float(np.mean((field - smooth) ** 2))
        alpha = var_s / (var_s + var_n) if var_s + var_n > 0 else 0.0
        parts.append(alpha * smooth)
    return np.exp(parts[0] + 1j * parts[1])


def write_table(out, rows, u0, du, e0, de, nu, ne, errs=None):
    lines = [
        '"""AUTO-GENERATED by tools/rwz/calibrate_ecc.py — do not edit.',
        "",
        "Eccentric strong-field residual calibration R_lmn(u, e) from the",
        "first-principles eccentric RWZ solver (tools/rwz/eccentric.py):",
        "COMPLEX per-mode amplitude ratio exact / (model x B_lm) on the",
        "regular (u, e) orbit grid (u = log(p - p_sep + U_SHIFT)),",
        "robust-cleaned (clean_table: isolated solver glitches rejected",
        "against the 3x3 neighborhood, amplitude-floor holes smooth-filled,",
        "measured-noise-driven shrinkage toward the smooth field).",
        "Multiplies the complex per-mode amplitudes on top of the circular",
        "B_lm(x_mn) table (|R|: modulus residual, arg R: phase residual).",
        "",
        "R_ERR_REL: per-node relative quadrature-error estimate for R",
        "(embedded half-resolution comparison, conservative; see",
        "tools/rwz/eccentric.py ``return_coarse``). Zero where R = 1",
        "(uncalibrated); replaced/filled nodes carry their calibrated",
        "neighborhood's median error.",
        '"""',
        "",
        "import numpy as np",
        "",
        f"U0 = {float(u0)!r}",
        f"DU = {float(du)!r}",
        f"E0 = {float(e0)!r}",
        f"DE = {float(de)!r}",
        f"N_U = {nu}",
        f"N_E = {ne}",
        "",
        "R_TABLE = {",
    ]
    for key in sorted(rows):
        flat = ", ".join(
            f"{v.real:.10g}{v.imag:+.10g}j" for v in rows[key].ravel()
        )
        lines.append(
            f"    {key}: np.array([{flat}]).reshape({nu}, {ne}),"
        )
    lines.append("}")
    lines.append("")
    lines.append("R_ERR_REL = {")
    for key in sorted(errs or {}):
        flat = ", ".join(f"{v:.3g}" for v in errs[key].ravel())
        lines.append(
            f"    {key}: np.array([{flat}]).reshape({nu}, {ne}),"
        )
    lines.append("}")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", out, f"({len(rows)} mode rows)")


def _err_summary(rows, errs):
    """Per-family median/max relative error of calibrated nodes (stdout)."""
    fam = {}
    for (l, m, n), err in errs.items():
        mask = np.abs(rows[(l, m, n)] - 1.0) > 1e-12
        vals = err[mask & (err > 0)]
        if vals.size:
            fam.setdefault((l, m), []).extend(vals.tolist())
    for key in sorted(fam):
        v = np.asarray(fam[key])
        print(f"  family {key}: median err {np.median(v):.2e}, "
              f"p95 {np.percentile(v, 95):.2e}, max {v.max():.2e}")


def clean_existing(path):
    """Re-apply clean_table to an already-generated data module in place
    (the solve is hours; cleaning is deterministic and cheap)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_ecc_existing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    errs = getattr(mod, "R_ERR_REL", None) or None
    rows, errs = clean_table(mod.R_TABLE, errs)
    write_table(path, rows, mod.U0, mod.DU, mod.E0, mod.DE,
                mod.N_U, mod.N_E, errs=errs)



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--nu", type=int, default=10)
    ap.add_argument("--ne", type=int, default=6)
    ap.add_argument("--nlo", type=int, default=N_LO)
    ap.add_argument("--nhi", type=int, default=N_HI)
    ap.add_argument("--e-max", type=float, default=0.55)
    ap.add_argument("--families", type=str, default=None,
                    help='subset, e.g. "2,2 3,3" (default: all m 0..l)')
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--clean-existing", type=str, default=None,
                    help="skip the solve: re-clean and rewrite an "
                         "existing generated table in place")
    ap.add_argument("--from-raw", type=str, default=None,
                    help="skip the solve: re-clean from a saved raw npz "
                         "sidecar and write --out")
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if args.clean_existing:
        clean_existing(args.clean_existing)
        return
    if args.from_raw:
        from_raw(args.from_raw, args.out)
        return

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.families:
        fams = [tuple(int(v) for v in tok.split(","))
                for tok in args.families.split()]
    else:
        fams = [(l, m) for l in range(2, args.lmax + 1)
                for m in range(0, l + 1)]
    ns = list(range(args.nlo, args.nhi + 1))
    us, es = grid_axes(args.nu, args.ne, args.e_max)
    table = default_mode_table(max(abs(args.nlo), args.nhi), l_max=args.lmax)
    mode_idx = mode_index(table, fams, ns)

    rows = {k: np.ones((args.nu, args.ne), dtype=complex) for k in mode_idx}
    errs = {k: np.zeros((args.nu, args.ne)) for k in mode_idx}
    t_start = time.time()
    for i, u in enumerate(us):
        for j, e in enumerate(es):
            p = p_of_node(u, e)
            # fine quadrature near the separatrix, with the embedded
            # half-resolution error estimate per node
            n_chi = 1024 if i < args.nu // 3 else 512
            node = calibrate_node(p, float(e), n_chi, table, mode_idx, device=device)
            for key, (r, err) in node.items():
                rows[key][i, j] = r
                errs[key][i, j] = err
            print(
                f"node ({i},{j}) p={p:7.3f} e={e:.2f}: {len(node)} modes, "
                f"{time.time() - t_start:7.0f}s elapsed", flush=True,
            )

    # persist the RAW solve (npz sidecar): cleaning policy can then be
    # iterated without re-running the hours-long solve
    raw_path = raw_path_for(args.out)
    np.savez_compressed(
        raw_path,
        keys=np.array(sorted(rows), dtype=np.int64),
        rows=np.stack([rows[k] for k in sorted(rows)]),
        errs=np.stack([errs[k] for k in sorted(rows)]),
        grid=np.array([us[0], us[1] - us[0], es[0], es[1] - es[0],
                       args.nu, args.ne]),
    )
    print("raw solve saved to", raw_path)

    rows, errs = clean_table(rows, errs)
    _err_summary(rows, errs)
    write_table(args.out, rows, us[0], us[1] - us[0], es[0], es[1] - es[0],
                args.nu, args.ne, errs=errs)


if __name__ == "__main__":
    sys.exit(main())
