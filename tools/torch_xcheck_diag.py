"""Decompose the banded-vs-general kernel cross-check residual (gate 1), on
the PyTorch port.

The port's counterpart of ``tools/xcheck_diag.py``: gate 1's configuration
(1-yr grid at dt = 10 s, rwz physics, the eps = 1e-2 selection frozen to 16
slots, 64-bin runs, turnover_slots = 2) through the port's banded
uniform-grid path (the dense pass: the CUDA kernel on the card, its plain
version on the CPU) and its general sorted-grid kernel. Then it ablates:

  * banded node resolution: bins_per_run 64 / 32 / 16 -- if the residual
    falls with the banded node spacing, the banded kernel's uniform-in-f
    node grid is the under-resolved side;
  * general node resolution: nodes_per_segment 32 / 64 -- ditto for the
    general kernel's uniform-in-t nodes;
  * per-output worst bins -- where in the band the disagreement lives.

``--save`` on one device and ``--compare`` on another give each kernel's
agreement across devices at full width.

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    PYTHONPATH=. python tools/torch_xcheck_diag.py [--nf N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

T_YEARS, DT, EPS, K_MAX, MAX_STEPS = 1.0, 10.0, 1e-2, 16, 192
PHYS_KW = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)
SOURCE = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)
TURNOVER_SLOTS = 2


def positive_grid(nf: int = 0) -> np.ndarray:
    """The positive bins of the 1-yr, 10-s grid (the first ``nf`` if nf)."""
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import default_frequencies

    freq = default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    return f_np[:nf] if nf else f_np


def gate1_prologue(device, source=SOURCE, flux_grid=None):
    """Gate 1's prologue: the eps-selected modes of the 30-harmonic table,
    then the prologue again with exactly those modes kept. Returns
    (prologue, the selected sub-table)."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import waveform_prologue

    table = default_mode_table(30)
    kw = dict(t_years=T_YEARS, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS, flux_grid=flux_grid,
              device=device, **PHYS_KW)
    pro_sel = waveform_prologue(*source, table=table, **kw)
    sel_idx = pro_sel.sel.idx[0].cpu().numpy()
    table_k = table.take(sel_idx)
    pro = waveform_prologue(*source, table=table_k, forced_idx=np.arange(len(sel_idx)), **kw)
    return pro, table_k


def banded(pro, table_k, f_np, sub, bins_per_run):
    """The banded uniform-grid path over the whole grid (no band windows),
    the four outputs at the bins ``sub``, float64 numpy."""
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import fd_waveform_core

    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))
    out = fd_waveform_core(pro, table_k, len(f_np), channels=True, uniform=uniform,
                           bins_per_run=bins_per_run, turnover_slots=TURNOVER_SLOTS)
    return [o[0].double().cpu().numpy()[sub] for o in out]


def general(pro, table_k, f_sub, nodes_per_segment):
    """The general sorted-grid kernel at the frequencies ``f_sub``."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import fd_waveform_core

    f = torch.as_tensor(np.asarray(f_sub), dtype=torch.float64, device=pro.t_knots.device)
    out = fd_waveform_core(pro, table_k, f, channels=True, turnover_slots=TURNOVER_SLOTS,
                           nodes_per_segment=nodes_per_segment)
    return [o[0].double().cpu().numpy() for o in out]


def rel(a4, b4):
    """Worst output's RMS(a - b) / RMS(a)."""
    worst = 0.0
    for x, y in zip(a4, b4):
        scale = np.sqrt(np.mean(x**2)) + 1e-300
        worst = max(worst, float(np.sqrt(np.mean((x - y) ** 2)) / scale))
    return worst


def worst_bins(b, g, count=12):
    """Indices (into the sub-grid) and errors of the ``count`` largest
    |b - g| / RMS(b) of the first output."""
    x, y = b[0], g[0]
    err = np.abs(x - y) / np.sqrt(np.mean(x**2))
    order = np.argsort(err)[::-1][:count]
    return order, err[order]


def ablation(b64, b32, b16, g32, g64):
    """The ablation table: (label, rel) rows in the original's order."""
    return [
        ("banded(r=32) vs general(s=32)", rel(b32, g32)),
        ("banded(r=16) vs general(s=32)", rel(b16, g32)),
        ("banded(r=64) vs general(s=64)", rel(b64, g64)),
        ("banded(r=16) vs general(s=64)", rel(b16, g64)),
        ("general(s=32) vs general(s=64)", rel(g32, g64)),
        ("banded(r=64) vs banded(r=16)", rel(b64, b16)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nf", type=int, default=0, help="0 = full 1-yr grid")
    ap.add_argument("--stride", type=int, default=617)
    ap.add_argument("--quick", action="store_true",
                    help="skip the ablation sweep, print the baseline only")
    ap.add_argument("--tpu", action="store_true",
                    help="the original's accelerator switch: the current CUDA device, as "
                         "with no --device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--save", type=str, default=None,
                    help="npz path: dump the baseline b64/g32 arrays")
    ap.add_argument("--compare", type=str, default=None,
                    help="npz from --save on the other device: report "
                         "per-kernel cross-device agreement")
    args = ap.parse_args(argv)

    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    f_np = positive_grid(args.nf)
    nf = len(f_np)
    pro, table_k = gate1_prologue(device)
    sub = np.arange(0, nf, args.stride)

    g32 = general(pro, table_k, f_np[sub], 32)
    b64 = banded(pro, table_k, f_np, sub, 64)
    base = rel(b64, g32)
    print(f"baseline  banded(r=64) vs general(s=32): {base:.3e}", flush=True)

    if args.save:
        np.savez(args.save, b64=np.stack(b64), g32=np.stack(g32))
        print(f"saved baseline arrays to {args.save}", flush=True)
    if args.compare:
        other = np.load(args.compare)
        print(
            f"banded THIS-dev vs OTHER-dev:  {rel(b64, list(other['b64'])):.3e}",
            flush=True,
        )
        print(
            f"general THIS-dev vs OTHER-dev: {rel(g32, list(other['g32'])):.3e}",
            flush=True,
        )

    if args.quick:
        return dict(baseline=base)

    b32 = banded(pro, table_k, f_np, sub, 32)
    b16 = banded(pro, table_k, f_np, sub, 16)
    g64 = general(pro, table_k, f_np[sub], 64)
    rows = ablation(b64, b32, b16, g32, g64)
    for label, value in rows:
        print(f"{label}: {value:.3e}", flush=True)

    # locate the worst bins of the baseline comparison
    order, errs = worst_bins(b64, g32)
    print("worst bins (idx in sub, f[Hz], rel err):")
    for i, err in zip(order, errs):
        print(f"  {i:6d}  f={f_np[sub[i]]:.6e}  {err:.3e}")
    return dict(baseline=base, **dict(rows))


if __name__ == "__main__":
    main()
