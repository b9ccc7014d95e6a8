"""Strong-field FLUX-level validation of the corrected eccentric stack, on
the PyTorch port.

The port's counterpart of ``tools/rwz/ecc_flux_check.py``. At held-out
GRID-CELL MIDPOINTS of the residual table it compares the total energy flux

    F = sum_lmn omega_mn^2 |A_lmn|^2 / (8 pi)

over the calibrated mode set (l <= 4 families, n in [N_LO, N_HI], the rows
of ``models/_rwz_ecc_data.py``) between

  * the first-principles eccentric RWZ solver (tools/rwz/eccentric.py),
  * the port's model stack WITHOUT the eccentric residual (tail +
    factorized + circular B_lm), and
  * the port's full production stack WITH the residual table (= what
    ``flux_from_modes(tail=True, factorized=True, rwz=True)`` sums).

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    python -m tools.rwz.torch_ecc_flux_check [--points N]  (~2-6 min solver time)
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _model_pieces(p: float, e: float, n_chi: int = 1024, device=None):
    """Per-mode model content over the calibrated set (f64, no solver)."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends import u_of_pe
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    from .eccentric import darwin_orbit
    from .torch_calibrate_ecc import (
        N_HI,
        N_LO,
        OMEGA_MIN,
        circular_correction,
        model_amplitudes_f64,
    )
    from .torch_holdout_check import table_residual

    dev = resolve_device(device)
    table = default_mode_table(max(abs(N_LO), N_HI), l_max=4)
    tls, tms, tns = table.ls, table.ms, table.ns
    keep = (tns >= N_LO) & (tns <= N_HI)

    orb = darwin_orbit(p, e, n_chi)
    a_base = model_amplitudes_f64(p, e, orb, table, tls, tms, tns, device=dev)
    om_all = tms * orb["Om_phi"] + tns * orb["Om_r"]
    b_circ = circular_correction(tls, tms, om_all, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    u = float(u_of_pe(torch.tensor(p, **f64), torch.tensor(e, **f64)))
    r_tab = table_residual(table, u, e, dev)
    keep &= np.abs(om_all) >= OMEGA_MIN
    return dict(
        orb=orb, tls=tls, tms=tms, tns=tns, keep=keep, om_all=om_all,
        a_base=a_base, b_circ=b_circ, r_tab=r_tab,
    )


def _model_fluxes(p: float, e: float, n_chi: int = 1024, device=None):
    """(F_no_residual, F_with_residual): the model side."""
    d = _model_pieces(p, e, n_chi, device)
    w = d["om_all"] ** 2 / (8.0 * np.pi)
    amp_no = np.abs(d["a_base"] * d["b_circ"]) ** 2
    amp_r = np.abs(d["a_base"] * d["b_circ"] * d["r_tab"]) ** 2
    k = d["keep"]
    return float(np.sum(w[k] * amp_no[k])), float(np.sum(w[k] * amp_r[k]))


def flux_triplet(p: float, e: float, n_chi: int = 1024, device=None):
    """(F_solver, F_model_noR, F_model_R) over the calibrated mode set."""
    from .eccentric import eccentric_amplitude
    from .torch_calibrate_ecc import rwz_units

    d = _model_pieces(p, e, n_chi, device)
    tls, tms, tns = d["tls"], d["tms"], d["tns"]
    om_all, a_base, b_circ, r_tab = (
        d["om_all"], d["a_base"], d["b_circ"], d["r_tab"]
    )
    f_sol = f_no = f_r = 0.0
    for k in np.where(d["keep"])[0]:
        l, m, n = int(tls[k]), int(tms[k]), int(tns[k])
        om = float(om_all[k])
        c_rwz, _ = eccentric_amplitude(l, m, n, p, e, _orbit=d["orb"])
        a_sol = rwz_units(l, m, c_rwz, om)
        w = om * om / (8.0 * np.pi)
        f_sol += w * abs(a_sol) ** 2
        f_no += w * abs(a_base[k] * b_circ[k]) ** 2
        f_r += w * abs(a_base[k] * b_circ[k] * r_tab[k]) ** 2
    return f_sol, f_no, f_r


def held_out_points(points):
    """(p, e) of ``points`` held-out midpoints along the grid diagonal
    (never calibration nodes)."""
    from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_ecc_data as ecc
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends import _U_SHIFT

    iu = np.linspace(4.5, ecc.N_U - 3.5, points)
    ie = np.linspace(3.5, ecc.N_E - 3.5, points)
    out = []
    for ju, je in zip(iu, ie):
        u = ecc.U0 + ju * ecc.DU
        e = float(ecc.E0 + je * ecc.DE)
        out.append((float(np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e), e))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rows = []
    for p, e in held_out_points(args.points):
        f_sol, f_no, f_r = flux_triplet(p, e, device=device)
        rows.append(
            dict(
                p=round(p, 6), e=round(e, 6),
                F_solver=float(f_sol),
                ratio_no_residual=float(f_no / f_sol),
                ratio_with_residual=float(f_r / f_sol),
            )
        )
        print(
            f"p={p:8.4f} e={e:5.3f}: F_solver={f_sol:.6e}  "
            f"model/solver no-R={f_no / f_sol:.5f}  with-R={f_r / f_sol:.6f}"
        )
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
