"""Generate the strong-field circular calibration table, on the PyTorch port.

The port's counterpart of ``tools/rwz/calibrate.py``. For every (l, m)
amplitude family (m >= 1, l <= 8) it computes, on a log-uniform grid of the
circular PN parameter x = 1/r0, the modulus ratio

    B_lm(x) = sqrt( F_exact_lm(x) / F_model_lm(x) ),

where F_exact is the first-principles RWZ flux (tools/rwz/circular.py:
sympy-derived master equations, scipy integration) and F_model is the
port's factorized-resummation per-mode flux (`mode_amplitudes`,
`fundamental_frequencies`, `tail_modulus_sq`, `factorized_correction`,
tail + factorized: the production amplitude pipeline), computed for the
whole x grid in one batch on the chosen torch device. B_lm is the residual
relativistic amplitude content the truncated rho_lm series misses.

Writes ``emri_frequencydomainwaveforms_tpu_torch/models/_rwz_calibration_data.py``
unless ``--out`` names another file.

Run:  python -m tools.rwz.torch_calibrate [--out <path>] [--device cpu]
"""

from __future__ import annotations

import argparse
from math import factorial, pi

import numpy as np

X_LO = 2.5e-3  # r0 = 400
X_HI = 1.0 / 6.08  # just outside the ISCO
N_X = 28

OUT = "emri_frequencydomainwaveforms_tpu_torch/models/_rwz_calibration_data.py"


def x_grid():
    """The table's log-uniform x nodes."""
    return np.exp(np.linspace(np.log(X_LO), np.log(X_HI), N_X))


def calibration_pairs(table):
    """The (l, m) families the table calibrates: m >= 1, l <= 8."""
    return sorted(
        {(int(l), int(m)) for l, m in zip(table.ls, table.ms) if m >= 1 and l <= 8}
    )


def model_flux_modes(pairs, xs, table, device=None):
    """F_model of each (l, m) on circular orbits r0 = 1/x: (len(pairs),
    len(xs)) numpy, NaN for a family without an (l, m, 0) mode in ``table``.
    One batched amplitude evaluation over every x."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import mode_amplitudes
    from emri_frequencydomainwaveforms_tpu_torch.models.geodesic import fundamental_frequencies
    from emri_frequencydomainwaveforms_tpu_torch.models.rho import factorized_correction
    from emri_frequencydomainwaveforms_tpu_torch.models.tail import tail_modulus_sq
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    p = torch.as_tensor(1.0 / np.asarray(xs, dtype=np.float64), device=dev)
    e = torch.zeros_like(p)
    ar, ai = mode_amplitudes(p, e, table)  # (X, M)
    om_phi, _ = fundamental_frequencies(p, e)  # (X,)
    out = np.full((len(pairs), len(xs)), np.nan)
    for row, (l, m) in enumerate(pairs):
        idx = np.where((table.ls == l) & (table.ms == m) & (table.ns == 0))[0]
        if len(idx) == 0:
            continue
        idx = int(idx[0])
        om = m * om_phi
        power = ar[:, idx] ** 2 + ai[:, idx] ** 2
        power = power * tail_modulus_sq(np.array([l]), om[:, None])[:, 0]
        s_rho, _ = factorized_correction(
            np.array([l]), np.array([m]), p, e, om[:, None], include_delta=False,
        )
        out[row] = ((1 / (8 * np.pi)) * om**2 * power * s_rho[:, 0] ** 2).cpu().numpy()
    return out


def exact_flux_mode(l, m, x):
    """F_exact of one (l, m) at x from the circular RWZ solver."""
    from .circular import even_circular_amplitude, odd_circular_amplitude

    n_l = factorial(l + 2) / factorial(l - 2) / (8 * pi)
    r0 = 1.0 / x
    if (l + m) % 2 == 0:
        c, om = even_circular_amplitude(l, m, r0)
        return n_l * abs(om * c / 2.0) ** 2
    c, om = odd_circular_amplitude(l, m, r0)
    return n_l * abs(c) ** 2


def b_row(l, m, xs, f_model):
    """B_lm over ``xs`` from the model fluxes ``f_model`` (None when the
    family has no model flux at some x)."""
    vals = np.ones(len(xs))
    for i, x in enumerate(xs):
        fm = f_model[i]
        if not np.isfinite(fm) or fm == 0.0:
            return None
        vals[i] = np.sqrt(exact_flux_mode(l, m, x) / fm)
    return vals


def table_lines(rows):
    """The generated module's lines for the B rows ``{(l, m): values}``."""
    lines = [
        '"""AUTO-GENERATED by tools/rwz/calibrate.py — do not edit.',
        "",
        "Strong-field circular amplitude calibration B_lm(x) from the",
        "first-principles RWZ solver (see tools/rwz/): modulus ratio",
        "exact/factorized-model per (l, m) on a log-uniform x grid.",
        "x = circular-equivalent PN parameter (models/rho.py _x_of_mode).",
        '"""',
        "",
        "import numpy as np",
        "",
        f"X_LO = {X_LO!r}",
        f"X_HI = {X_HI!r}",
        f"N_X = {N_X}",
        "",
        "B_TABLE = {",
    ]
    for key, vals in rows.items():
        arr = ", ".join(f"{v!r}" for v in vals)
        lines.append(f"    {key}: np.array([{arr}]),")
    lines.append("}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table

    table = default_mode_table(2, l_max=8)
    pairs = calibration_pairs(table)
    xs = x_grid()
    f_model = model_flux_modes(pairs, xs, table, args.device)

    rows = {}
    for (l, m), fm in zip(pairs, f_model):
        vals = b_row(l, m, xs, fm)
        if vals is None:
            print(f"({l},{m}): skipped (no model flux)")
            continue
        rows[(l, m)] = vals
        print(f"({l},{m}): B range [{vals.min():.6f}, {vals.max():.6f}]")

    with open(args.out, "w") as fh:
        fh.write("\n".join(table_lines(rows)) + "\n")
    print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()
