"""Held-out validation of the eccentric RWZ residual table, on the PyTorch
port.

The port's counterpart of ``tools/rwz/holdout_check.py``. It solves the
eccentric RWZ amplitudes at GRID-CELL MIDPOINTS -- orbits the calibration
never saw -- and compares them with the port's interpolation of its table
(`models/rwz_calibration.py::rwz_ecc_residual` on
``models/_rwz_ecc_data.py``, exactly as production applies it). The
measured midpoint deviation is the table's interpolation + residual-model
error.

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    python -m tools.rwz.torch_holdout_check [--modes "2,2,0 3,3,2 ..."]

Prints a per-mode table (max/median relative deviation over midpoints).
"""

from __future__ import annotations

import argparse

import numpy as np

DEFAULT_MODES = "2,2,0 2,2,2 2,0,1 2,1,1 3,3,1 3,1,3 4,4,0 4,2,2 3,3,6"


def midpoints(n_mid):
    """(u, e) of ``n_mid`` cell centres along the table's diagonal."""
    from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_ecc_data as ecc

    iu = np.linspace(0.5, ecc.N_U - 1.5, n_mid)
    ie = np.linspace(0.5, ecc.N_E - 1.5, n_mid)
    return ecc.U0 + iu * ecc.DU, ecc.E0 + ie * ecc.DE


def table_residual(table, u, e, device=None):
    """The port's interpolated R per mode at (u, e), numpy complex."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.rwz_calibration import rwz_ecc_residual
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    r_re, r_im = rwz_ecc_residual(
        table.ls, table.ms, table.ns, torch.tensor(float(u), dtype=torch.float64, device=dev),
        torch.tensor(float(e), dtype=torch.float64, device=dev),
    )
    return r_re.cpu().numpy() + 1j * r_im.cpu().numpy()


def midpoint_devs(u, e, table, mode_idx, device=None):
    """{(l, m, n): (R deviation, amplitude deviation)} at one midpoint:
    |R_table / R_true - 1|, and the applied amplitude's error relative to
    the exact mode amplitude floored at 1e-3 of the orbit's dominant mode
    (near model zero-crossings R is singular while the product A B R stays
    bounded)."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends import _U_SHIFT

    from .eccentric import darwin_orbit, eccentric_amplitude
    from .torch_calibrate_ecc import baseline, rwz_units

    p = float(np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e)
    e = float(e)
    orb = darwin_orbit(p, e, 1024)
    a_bb, om_all = baseline(p, e, orb, table, device)
    r_interp = table_residual(table, u, e, device)
    a_dominant = float(np.max(np.abs(a_bb * r_interp)))
    out = {}
    for (l, m, n), k in mode_idx.items():
        om = float(om_all[k])
        if abs(om) < 2e-3 or abs(a_bb[k]) == 0:
            continue
        c_rwz, _ = eccentric_amplitude(l, m, n, p, e, _orbit=orb)
        a_rwz = rwz_units(l, m, c_rwz, om)
        r_true = a_rwz / a_bb[k]
        a_applied = a_bb[k] * r_interp[k]
        floor = max(abs(a_rwz), 1e-3 * a_dominant)
        out[(l, m, n)] = (abs(r_interp[k] / r_true - 1.0), abs(a_applied - a_rwz) / floor)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", type=str, default=DEFAULT_MODES)
    ap.add_argument("--n-mid", type=int, default=6,
                    help="midpoints along the u diagonal")
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    from .torch_calibrate_ecc import mode_index

    device = resolve_device(args.device)
    modes = [tuple(int(v) for v in tok.split(",")) for tok in args.modes.split()]
    table = default_mode_table(12, l_max=4)
    mode_idx = {}
    for key in modes:
        mode_idx.update(mode_index(table, [key[:2]], [key[2]]))

    devs = {k: [] for k in mode_idx}
    amp_devs = {k: [] for k in mode_idx}
    for u, e in zip(*midpoints(args.n_mid)):
        for key, (d, a) in midpoint_devs(u, e, table, mode_idx, device).items():
            devs[key].append(d)
            amp_devs[key].append(a)

    print("held-out midpoint check — table bilinear R vs exact midpoint "
          "solve:")
    print("| mode | n_pts | R dev median | R dev max | amp dev median | "
          "amp dev max |")
    print("|---|---|---|---|---|---|")
    for key in sorted(devs):
        d = np.asarray(devs[key])
        a = np.asarray(amp_devs[key])
        if not d.size:
            continue
        print(
            f"| {key} | {d.size} | {np.median(d):.2e} | {d.max():.2e} | "
            f"{np.median(a):.2e} | {a.max():.2e} |"
        )
    print(
        "('amp dev' = applied-amplitude error relative to the exact mode "
        "amplitude, floored at 1e-3 of the orbit's dominant mode — the "
        "waveform-level impact.)"
    )
    return devs, amp_devs


if __name__ == "__main__":
    main()
