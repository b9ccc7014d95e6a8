"""FD-construction walkthrough (PyTorch port): the single-mode SPA build.

The port's counterpart of ``examples/fd_construction.py``, a runnable
version of the reference's pedagogy notebook
``Tutorial_FD_construction_single_mode.ipynb`` (cells 22-32): construct the
frequency-domain waveform of ONE harmonic step by step (trajectory, phase
spline, frequency evolution and its inversion t(f), the SPA amplitude with
the uniform Bessel-K(1/3) correction), then check it against the FFT of the
time-domain waveform built from the SAME splines, the notebook's
"fd_h vs fft(td_h) * dt" comparison.

Run on the current CUDA device, or on the CPU with ``--device cpu``
(CI-quick by default; ``--plot`` writes a figure):

    PYTHONPATH=. python examples/torch_fd_construction.py
    PYTHONPATH=. python examples/torch_fd_construction.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import (
    ModeTable,
    default_mode_table,
)
from emri_frequencydomainwaveforms_tpu_torch.models.waveform import (
    default_frequencies,
    default_time_grid,
    fd_waveform_core,
    td_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu_torch.ops.cubic_spline import (
    fit_cubic_spline,
    spline_eval,
)
from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device
from emri_frequencydomainwaveforms_tpu_torch.utils.fdutils import (
    get_fd_windowed,
    get_fft_td_windowed,
)


def _host(x):
    return x[0].cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--T", type=float, default=0.1, help="observation years")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- source (notebook cell 2's tutorial configuration, shortened) ----
    M, mu, p0, e0 = 1e6, 10.0, 11.0, 0.35
    theta, phi = 0.7, 0.5
    T, dt = args.T, 10.0

    # ---- step 1: trajectory + phases (notebook cells 5-9) ----
    # waveform_prologue = trajectory ODE -> amplitudes -> eps selection ->
    # spline-ready knots; the single (2,2,0) mode is forced explicitly
    table = ModeTable(np.array([2]), np.array([2]), np.array([0]))
    pro = waveform_prologue(
        M, mu, p0, e0, theta, phi, 1.0, 0.0, 0.0,
        t_years=T, table=table, k_max=1, eps=1e-9, device=device,
    )
    n_live = int(pro.n_live[0])
    print(f"trajectory: {n_live} adaptive knots over {T} yr")

    # ---- step 2: the mode's phase and frequency evolution (cells 11-17) ----
    sp_phi = fit_cubic_spline(pro.t_knots, pro.phi_phi, bc="not-a-knot")
    t_knots = _host(pro.t_knots)[:n_live]
    f_mode = _host(spline_eval(sp_phi, pro.t_knots, deriv=1))[:n_live]
    f_mode = 2.0 * f_mode / (2.0 * np.pi)  # m = 2, n = 0: f = 2 Omega_phi/2pi
    print(
        f"f_22 sweeps {f_mode[0] * 1e3:.4f} -> {f_mode[-1] * 1e3:.4f} mHz "
        "(monotone chirp, invertible t(f))"
    )
    assert np.all(np.diff(f_mode) > 0), "monotone band required for t(f)"

    # ---- step 3: FD via the SPA kernel (cells 22-26) ----
    freq = default_frequencies(T, dt)
    f_pos = freq[freq > 0]
    hp_r, hp_i, _hc_r, _hc_i = fd_waveform_core(
        pro, table, torch.as_tensor(f_pos, device=device), channels=True)
    fd_hp = _host(hp_r) + 1j * _host(hp_i)
    band = (f_pos >= f_mode[0]) & (f_pos <= f_mode[-1])
    print(
        f"FD kernel: {band.sum()} in-band bins of {len(fd_hp)}; "
        f"peak |h+~| = {np.abs(fd_hp).max():.3e}"
    )

    # ---- step 4: the notebook's ground-truth check (cells 26-32):
    # fft(td_h) * dt from the SAME splines must overlay the SPA result ----
    hp_td, hc_td = (_host(h) for h in td_waveform_core(pro, table, default_time_grid(T, dt)))
    w = np.hanning(len(hp_td))  # windowing tames spectral leakage (cell 28)
    td_w = get_fft_td_windowed([hp_td, hc_td], w, dt)
    full_hp = np.zeros(len(freq), complex)
    full_hp[freq > 0] = fd_hp
    full_hp[freq < 0] = np.conj(fd_hp)[::-1]
    fd_hp_w = get_fd_windowed([full_hp], w)[0]

    pos = freq > 0
    fft_hp = td_w[0][pos]
    fd_cmp = fd_hp_w[pos]
    num = np.abs(np.vdot(fd_cmp, fft_hp))
    den = np.sqrt(np.vdot(fd_cmp, fd_cmp).real * np.vdot(fft_hp, fft_hp).real)
    mismatch = 1.0 - num / den
    print(f"single-mode FD vs fft(TD)*dt Hann mismatch: {mismatch:.3e}")
    # SPA truncation scales as 1/w ~ fddot^2/fdot^3: slow short chirps sit
    # higher (T = 0.1 yr: ~5e-3; T = 0.35: ~4e-4; at 1 yr the production
    # configuration reaches ~7e-5)
    gate = 1e-2 if T < 0.3 else 1e-3
    assert mismatch < gate, "the notebook's core claim (T-scaled gate)"

    # ---- step 5: mass invariance of the rescaled spectrum (tutorial
    # notebook's invariance demo): h(f)/M^2 vs f*M matches across masses
    # (geometric-unit scaling of the quadrupole chirp) ----
    table_all = default_mode_table(8, l_max=2)
    spectra = {}
    for m_scale in (1.0, 2.0):
        pro_s = waveform_prologue(
            M * m_scale, mu * m_scale, p0, e0, theta, phi, 1.0, 0.0, 0.0,
            t_years=T * m_scale, table=table_all, k_max=8, eps=1e-2, device=device,
        )
        freq_s = default_frequencies(T * m_scale, dt * m_scale)
        f_pos_s = freq_s[freq_s > 0]
        o = fd_waveform_core(pro_s, table_all, torch.as_tensor(f_pos_s, device=device),
                             channels=True)
        spectra[m_scale] = (f_pos_s * m_scale, (_host(o[0]) + 1j * _host(o[1])) / m_scale**2)
    fM1, h1 = spectra[1.0]
    fM2, h2 = spectra[2.0]
    h2i = np.interp(fM1, fM2, np.abs(h2))
    sel = (np.abs(h1) > np.abs(h1).max() * 1e-3) & (fM1 > fM2[0]) & (fM1 < fM2[-1])
    ratio = h2i[sel] / np.abs(h1)[sel]
    print(
        f"mass invariance |h|/M^2 at fixed f*M: ratio median {np.median(ratio):.4f}"
    )
    assert abs(np.median(ratio) - 1.0) < 0.05

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(2, 1, figsize=(8, 7))
        fsub = f_pos[band]
        ax[0].semilogy(fsub * 1e3, np.abs(fd_hp_w[pos][band]), label="SPA FD (windowed)")
        ax[0].semilogy(fsub * 1e3, np.abs(fft_hp[band]), "--", label="fft(TD) * dt")
        ax[0].set_xlabel("f [mHz]")
        ax[0].set_ylabel("|h+~|")
        ax[0].legend()
        ax[1].plot(t_knots / 86400.0, f_mode * 1e3)
        ax[1].set_xlabel("t [days]")
        ax[1].set_ylabel("f_22(t) [mHz]")
        fig.tight_layout()
        fig.savefig("torch_fd_construction.png", dpi=110)
        print("wrote torch_fd_construction.png")

    print("OK")
    return dict(n_live=n_live, f_start=float(f_mode[0]), f_end=float(f_mode[-1]),
                in_band_bins=int(band.sum()), peak_hp=float(np.abs(fd_hp).max()),
                mismatch=float(mismatch), gate=gate, ratio_median=float(np.median(ratio)))


if __name__ == "__main__":
    main()
