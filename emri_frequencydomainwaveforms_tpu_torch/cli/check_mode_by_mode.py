"""TD-vs-FD accuracy and timing scan, on the GPU.

Counterpart of ``emri_frequencydomainwaveforms_tpu.cli.check_mode_by_mode``,
with the same flags, flow, results and HDF5 layout: for each of ``-nsteps``
draws from the prior (``numpy.random.default_rng(seed)``, as the reference)
fix p0 by a duration solve so the inspiral lasts 0.99 Tobs, generate the
source in the FD on the full grid, in the FD on the downsampled positive
grid and in the TD, time the three calls, and record the SNR, the windowed
FD/TD mismatch for the boxcar, Blackman, Hann and Nuttall windows and the
log-likelihood of the Hann-windowed residual. A point that raises is
recorded in ``failed_points`` and the scan goes on, as in the reference.

    python -m emri_frequencydomainwaveforms_tpu_torch.cli.check_mode_by_mode \\
        -Tobs 1 -nsteps 3 -dt 10 -eps 1e-2 -dev 0 -outname scan.h5

``-dev N`` selects ``cuda:N``. The generators return host numpy arrays, so
each timing holds the card's work for that call. The output file needs
h5py; from Python, ``run_check(args, device=..., write=False)`` returns the
results without it (``device="cpu"`` runs the plain paths). The reference's
``_enable_compile_cache`` (XLA's persistent compile cache) has no
counterpart and is not ported: nothing here is traced or compiled per run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

WINDOWS = ["boxcar", "blackman", "hann", "nuttall"]


def build_parser():
    p = argparse.ArgumentParser(
        description="TD-vs-FD scan on the GPU (PyTorch port of cli.check_mode_by_mode)")
    p.add_argument("-Tobs", "--Tobs", type=float, default=0.1)
    p.add_argument("-dt", "--dt", type=float, default=10.0)
    p.add_argument("-eps", "--eps", type=float, default=1e-2)
    p.add_argument("-nsteps", "--nsteps", type=int, default=3, help="number of random draws")
    p.add_argument("-dev", "--dev", type=int, default=0, help="CUDA device index")
    p.add_argument("-downsample", "--downsample", type=int, default=100)
    p.add_argument("-random_modes", "--random_modes", type=int, default=0,
                   help="draw one random (l,m,n) mode per point instead of eps-selection")
    p.add_argument("-outname", "--outname", type=str, default="check_mode_by_mode.h5")
    p.add_argument("--seed", type=int, default=2601996)
    p.add_argument("-turnover_slots", "--turnover_slots", type=int, default=2,
                   help="extra FD kernel slots for post-turnover branches")
    p.add_argument("-negative_slots", "--negative_slots", type=int, default=0,
                   help="extra FD kernel slots for negative-frequency ranges")
    p.add_argument("-flux", "--flux", type=str, default="multipole_rwz",
                   choices=["pm", "multipole", "multipole_tail",
                            "multipole_factorized", "multipole_rwz"],
                   help="trajectory dissipation model (default: the calibrated rwz stack)")
    p.add_argument("-amp", "--amp", type=str, default="rwz",
                   choices=["flat", "tail", "factorized", "rwz"],
                   help="amplitude physics: flat-space multipoles, + wave-tail factor, "
                        "+ factorized resummation, + rwz strong-field calibration (default)")
    return p


def run_check(args, device=None, write=True) -> dict:
    """The scan; ``device`` defaults to ``cuda:<args.dev>``. ``write=False``
    returns the results without writing ``args.outname``."""
    import torch

    from ..inference.prior import ProbDistContainer, uniform_dist
    from ..lisa.diagnostic import inner_product, snr
    from ..lisa.sensitivity import get_sensitivity
    from ..models.inspiral import get_p_at_t
    from ..models.waveform import GenerateEMRIWaveform
    from ..utils import windows as win_mod
    from ..utils.device import resolve_device
    from ..utils.fdutils import get_fd_windowed, get_fft_td_windowed

    dev = resolve_device(device if device is not None else torch.device("cuda", args.dev))
    rng = np.random.default_rng(args.seed)
    priors = ProbDistContainer(
        {
            0: uniform_dist(np.log(5e5), np.log(4e6)),
            1: uniform_dist(np.log(1e-5), np.log(1e-4)),
            2: uniform_dist(0.1, 0.5),  # e0
        }
    )

    amp_kwargs = dict(
        tail=args.amp in ("tail", "factorized", "rwz"),
        factorized=args.amp in ("factorized", "rwz"),
        rwz=args.amp == "rwz",
    )
    td_gen = GenerateEMRIWaveform(
        sum_kwargs=dict(odd_len=True, flux=args.flux),
        amplitude_kwargs=amp_kwargs, return_list=True, device=dev,
    )
    fd_gen = GenerateEMRIWaveform(
        sum_kwargs=dict(
            output_type="fd", odd_len=True, flux=args.flux,
            turnover_slots=args.turnover_slots,
            negative_slots=args.negative_slots,
        ), amplitude_kwargs=amp_kwargs, return_list=True, device=dev,
    )

    def noise(f):
        return np.asarray(get_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd"))

    results = {
        "T": args.Tobs,
        "dt": args.dt,
        "eps": args.eps,
        "list_injections": [],
        "timing_td": [],
        "timing_fd": [],
        "timing_fd_downsampled": [],
        "mismatch": {w: [] for w in WINDOWS},
        "SNR": [],
        "loglike": [],
        "failed_points": [],
    }

    mode_pool = [(2, 2, n) for n in range(-3, 6)] + [(2, 0, n) for n in range(1, 4)]

    for step in range(args.nsteps):
        draw = priors.rvs(size=1, random_state=rng)[0]
        m_central = float(np.exp(draw[0]))
        mu = float(np.exp(draw[0]) * np.exp(draw[1]))
        e0 = float(draw[2])
        try:
            p0 = float(get_p_at_t(m_central, mu, e0, 0.99 * args.Tobs, flux=args.flux,
                                  device=dev)[0])
            pars = [m_central, mu, 0.0, p0, e0, 1.0, 1.0,
                    np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6, 1.0, 0.0, 2.0]
            kw = dict(T=args.Tobs, dt=args.dt)
            if args.random_modes:
                kw["mode_selection"] = [mode_pool[rng.integers(len(mode_pool))]]
            else:
                kw["eps"] = args.eps

            tic = time.perf_counter()
            hfd = fd_gen(*pars, **kw)
            t_fd = time.perf_counter() - tic

            freq = fd_gen.frequency
            pos = freq > 0
            f_ds = freq[pos][:: max(args.downsample, 1)]
            tic = time.perf_counter()
            _ = fd_gen(*pars, f_arr=f_ds, **kw)
            t_fd_ds = time.perf_counter() - tic

            tic = time.perf_counter()
            htd = td_gen(*pars, **kw)
            t_td = time.perf_counter() - tic

            n = len(htd[0])
            fpos_mask = freq >= 0
            f_pos_arr = freq[fpos_mask]
            psd_ok = f_pos_arr > 1e-5  # keep out of the PSD's flushed corner
            snr_val = snr(
                [c[fpos_mask][psd_ok] for c in hfd],
                f_arr=f_pos_arr[psd_ok],
                PSD=noise,
            )
            results["SNR"].append(float(snr_val))

            for wname in WINDOWS:
                w = np.asarray(win_mod.WINDOWS[wname](n))
                fd_w = get_fd_windowed(hfd, w)
                td_w = get_fft_td_windowed(htd, w, args.dt)
                mism = []
                for a, b in zip(fd_w, td_w):
                    av, bv = a[fpos_mask], b[fpos_mask]
                    num = np.abs(np.vdot(av, bv))
                    den = np.sqrt(np.vdot(av, av).real * np.vdot(bv, bv).real)
                    mism.append(1.0 - num / den)
                results["mismatch"][wname].append(float(np.mean(mism)))

            # residual log-likelihood -1/2 <fd - td, fd - td>
            hann = np.asarray(win_mod.hann(n))
            fd_p = [c[fpos_mask][psd_ok] for c in get_fd_windowed(hfd, hann)]
            td_p = [c[fpos_mask][psd_ok] for c in get_fft_td_windowed(htd, hann, args.dt)]
            diff = [a - b for a, b in zip(fd_p, td_p)]
            ll = -0.5 * inner_product(diff, diff, f_arr=f_pos_arr[psd_ok], PSD=noise)
            results["loglike"].append(float(ll))

            results["list_injections"].append(pars)
            results["timing_fd"].append(t_fd)
            results["timing_fd_downsampled"].append(t_fd_ds)
            results["timing_td"].append(t_td)
            print(
                f"[{step}] M={m_central:.2e} mu={mu:.1f} e0={e0:.2f} p0={p0:.2f} "
                f"SNR={snr_val:.1f} hann-mism={results['mismatch']['hann'][-1]:.2e} "
                f"t_fd={t_fd:.2f}s t_td={t_td:.2f}s speedup={t_td / t_fd:.1f}x"
            )
        except Exception as exc:  # record and keep scanning, as the reference does
            print(f"[{step}] FAILED: {exc}")
            results["failed_points"].append([float(draw[0]), float(draw[1]), float(draw[2])])

    if write:
        _save_h5(args.outname, results)
    return results


def _save_h5(path: str, results: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for key in ("T", "dt", "eps"):
            f.attrs[key] = results[key]
        for key in (
            "list_injections",
            "timing_td",
            "timing_fd",
            "timing_fd_downsampled",
            "SNR",
            "loglike",
            "failed_points",
        ):
            f.create_dataset(key, data=np.asarray(results[key], dtype=np.float64))
        g = f.create_group("mismatch")
        for wname, vals in results["mismatch"].items():
            g.create_dataset(wname, data=np.asarray(vals))
    print(f"scan written to {path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_check(args)


if __name__ == "__main__":
    main()
