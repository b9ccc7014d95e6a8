"""Quickstart (PyTorch port): generate an FD EMRI waveform on the GPU.

The port's counterpart of ``examples/quickstart.py``: solve for the p0 that
makes a 0.99 T inspiral, then build the all-mode FD waveform (eps = 1e-2
selection, up to 48 modes) on every tenth positive bin of the default
10-s grid through the banded uniform-grid kernel, and print its checks.

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    PYTHONPATH=. python examples/torch_quickstart.py
    PYTHONPATH=. python examples/torch_quickstart.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import get_p_at_t
from emri_frequencydomainwaveforms_tpu_torch.models.waveform import (
    default_frequencies,
    fd_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=float, default=0.2, help="observation years")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("device:", device)

    # source: M = 1e6 Msun, mu = 10 Msun, a T-yr observation
    M, mu, e0, T, dt = 1e6, 10.0, 0.35, args.T, 10.0
    p0 = float(get_p_at_t(M, mu, e0, 0.99 * T, device=device)[0])
    print(f"p0 for a 0.99*T inspiral: {p0:.4f}")

    table = default_mode_table(30)
    freq = default_frequencies(T, dt)
    f_np = freq[freq > 0][::10]
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    pro = waveform_prologue(
        M, mu, p0, e0, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=T, table=table, k_max=48, eps=1e-2, device=device,
    )
    hpr, hpi, _hcr, _hci = fd_waveform_core(pro, table, len(f_np), channels=True,
                                            uniform=uniform)
    hp = hpr[0].cpu().numpy() + 1j * hpi[0].cpu().numpy()
    checks = dict(p0=p0, n_bins=len(f_np), peak_hp=float(np.abs(hp).max()),
                  nonzero_bins=int((np.abs(hp) > 0).sum()), finite=bool(np.isfinite(hp).all()))
    print(
        f"FD waveform on {len(f_np)} bins: peak |h+~| = {checks['peak_hp']:.3e}, "
        f"nonzero bins = {checks['nonzero_bins']}, finite = {checks['finite']}"
    )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.loglog(f_np, np.abs(hp))
        plt.xlabel("f [Hz]")
        plt.ylabel("|h+~|")
        plt.savefig("torch_quickstart.png", dpi=110)
        print("wrote torch_quickstart.png")
    return checks


if __name__ == "__main__":
    main()
