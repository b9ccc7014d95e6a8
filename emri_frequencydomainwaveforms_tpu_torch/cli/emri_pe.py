"""EMRI parameter-estimation command (MCMC over one source), on the GPU.

Counterpart of ``emri_frequencydomainwaveforms_tpu.cli.emri_pe``, with the
same flags and flow: fix p0 by a duration solve so the inspiral lasts
0.99 Tobs, freeze the eps mode selection at the injection (the production
fast path), inject an FD or TD signal on the downsampled positive grid,
whiten it with the Robson-Cornish-Liu PSD, start the walkers in a ball
around the truth (``numpy.random.default_rng(seed)``, as the reference) and
run the tempered stretch-move sampler, resuming from the chain file when it
holds one.

    python -m emri_frequencydomainwaveforms_tpu_torch.cli.emri_pe \\
        -Tobs 0.1 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 \\
        -template fd -injectFD 1 -downsample 100 \\
        -nwalkers 16 -ntemps 2 -nsteps 100

Each likelihood call evaluates its walkers as one batch: one prologue (the
trajectories of the whole batch in one loop) and one FD core, whose dense
pass is the hand-written CUDA kernel. ``-dev N`` selects ``cuda:N``; the
chain file needs h5py. From Python, `run_emri_pe` also takes ``device=``
(``"cpu"`` runs the plain paths) and ``backend=`` (an in-memory `Backend`
needs no h5py).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EMRI PE on the GPU (PyTorch port of cli.emri_pe)")
    p.add_argument("-Tobs", "--Tobs", type=float, default=1.0, help="observation time [yr]")
    p.add_argument("-M", "--M", type=float, default=1e6)
    p.add_argument("-mu", "--mu", type=float, default=10.0)
    p.add_argument("-p0", "--p0", type=float, default=12.0)
    p.add_argument("-e0", "--e0", type=float, default=0.35)
    p.add_argument("-dev", "--dev", type=int, default=0, help="CUDA device index")
    p.add_argument("-eps", "--eps", type=float, default=1e-2)
    p.add_argument("-dt", "--dt", type=float, default=10.0)
    p.add_argument("-injectFD", "--injectFD", type=int, default=1)
    p.add_argument("-template", "--template", type=str, default="fd", choices=["fd", "td"])
    p.add_argument("-downsample", "--downsample", type=int, default=100)
    p.add_argument("-nwalkers", "--nwalkers", type=int, default=16)
    p.add_argument("-ntemps", "--ntemps", type=int, default=1)
    p.add_argument("-nsteps", "--nsteps", type=int, default=10)
    p.add_argument("-window_flag", "--window_flag", type=int, default=0)
    p.add_argument("--outname", type=str, default=None)
    p.add_argument("--seed", type=int, default=2601996)
    p.add_argument("--start-scale", type=float, default=1e-7,
                   help="relative scale of the walker ball around the truth")
    p.add_argument("--start-cov", type=str, default=None,
                   help="npy file seeding the walkers: (ndim, ndim) covariance "
                        "or (N, ndim) posterior samples")
    p.add_argument("-kmax", "--kmax", type=int, default=48,
                   help="mode-slot budget of the template")
    p.add_argument("-max_steps", "--max_steps", type=int, default=512,
                   help="trajectory knot budget (1-yr inspirals use ~135 adaptive knots)")
    p.add_argument("--subset", type=int, default=None,
                   help="likelihood micro-batch size: evaluate the walkers in chunks "
                        "of this many to bound device memory")
    p.add_argument("--freeze-selection", dest="freeze_selection", type=int, default=1,
                   help="1 (default): freeze the eps mode selection at the injection "
                        "point and slice the mode table to it; 0: per-walker eps "
                        "selection over the full candidate table")
    p.add_argument("--plot", action="store_true",
                   help="corner plot of the cold chain, next to the chain file (needs matplotlib)")
    p.add_argument("-flux", "--flux", type=str, default="multipole_rwz",
                   choices=["pm", "multipole", "multipole_tail",
                            "multipole_factorized", "multipole_rwz"],
                   help="trajectory dissipation model (models.flux); default the "
                        "calibrated rwz stack, 'pm' the Peters-Mathews flux")
    p.add_argument("-amp", "--amp", type=str, default="rwz",
                   choices=["flat", "tail", "factorized", "rwz"],
                   help="amplitude rung: flat-space multipoles, + wave tail, "
                        "+ factorized resummation, + rwz calibration (default)")
    return p


def physics(args) -> dict:
    """The trajectory flux and the amplitude rungs ``args`` name."""
    return dict(
        flux=args.flux,
        tail=args.amp in ("tail", "factorized", "rwz"),
        factorized=args.amp in ("factorized", "rwz"),
        rwz=args.amp == "rwz",
    )


def parameter_transform():
    """The sampled (ln M, ln(mu / M), p0, e0, Phi_phi0, Phi_r0) -> the
    templates' 14 parameters: M and mu from their logs, the fixed ones
    filled in (a = 0, x = 1, dist 1 Gpc, qS, phiS, qK, phiK = pi/4, pi/3,
    pi/5, pi/6, Phi_theta0 = 0)."""
    from ..utils.transform import TransformContainer

    qS, phiS, qK, phiK = np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6
    dist = 1.0
    return TransformContainer(
        parameter_transforms={
            (0, 1): lambda lm, le: [torch.exp(lm), torch.exp(lm) * torch.exp(le)]
        },
        fill_dict={
            "ndim_full": 14,
            "fill_values": np.array([0.0, 1.0, dist, qS, phiS, qK, phiK, 0.0]),
            "fill_inds": np.array([2, 5, 6, 7, 8, 9, 10, 12]),
        },
    )


def template_prologue(args, table_t, forced_idx, *, flux_grid, device):
    """The templates' prologue: ``(n, 14)`` transformed parameters -> the
    `WaveformPrologue` of the (frozen) table ``table_t`` on ``device``."""
    from ..models.amplitude import family_constants
    from ..models.rwz_calibration import rwz_rows
    from ..models.waveform import waveform_prologue

    phys = physics(args)
    family_c = torch.as_tensor(family_constants(table_t), device=device)
    rows = rwz_rows(table_t.ls, table_t.ms, table_t.ns, device) if phys["rwz"] else None

    def prologue(params14):
        p = torch.as_tensor(params14, dtype=torch.float64).to(device)
        return waveform_prologue(
            p[:, 0], p[:, 1], p[:, 3], p[:, 4], p[:, 7], p[:, 8], p[:, 6], p[:, 11], p[:, 13],
            t_years=args.Tobs, table=table_t, k_max=args.kmax, eps=args.eps,
            max_steps=args.max_steps, forced_idx=forced_idx, family_c=family_c,
            flux_grid=flux_grid, rwz_rows=rows, device=device, **phys,
        )

    return prologue


def fd_template(args, table_t, forced_idx, f_arr, *, flux_grid, device, record=None):
    """The FD template on the uniform grid ``f_arr``: ``(n, 14)``
    transformed parameters -> [(h+ re, im), (hx re, im)], (n, nf) float32
    on ``device``, through the banded kernel; ``bins=(lo, hi)`` gives only
    those bins (a frequency shard, `fd_waveform_core`'s ``bin_range``).
    With a dict ``record``, each call stores its batch's live knots
    (``n_live``, (n,)) and spectra (``template``, (n, 4, bins)) there, on
    the CPU."""
    from ..models.waveform import fd_waveform_core

    prologue = template_prologue(args, table_t, forced_idx, flux_grid=flux_grid, device=device)
    uniform = (float(f_arr[0]), float(f_arr[1] - f_arr[0]))

    def template(params14, bins=None):
        pro = prologue(params14)
        out = fd_waveform_core(pro, table_t, len(f_arr), channels=True, uniform=uniform,
                               out_f32=True, bin_range=bins)
        if record is not None:
            record.update(n_live=pro.n_live.cpu(), template=torch.stack(out, dim=1).cpu())
        return [(out[0], out[1]), (out[2], out[3])]

    return template


def run_emri_pe(args, *, backend=None, device=None) -> dict:
    """Run the PE flow of ``args`` (a `build_parser` namespace).

    ``device`` defaults to ``cuda:<args.dev>``; ``backend`` to
    ``HDFBackend(outname)``. Returns the cold and hot chains, the truth, the
    injection SNR, the backend, the sampler, the likelihood, the solved p0,
    what rebuilds the template (`fd_template`'s table, forced slots, grid
    and flux grid), the injection trajectory's knot count (``n_knots``;
    None without the frozen selection) and the host-clock times of the
    stages (seconds).
    """
    from ..inference.ensemble import EnsembleSampler
    from ..inference.prior import ProbDistContainer, uniform_dist
    from ..lisa.diagnostic import snr
    from ..lisa.likelihood import Likelihood
    from ..lisa.sensitivity import get_sensitivity
    from ..models.amplitude import default_mode_table
    from ..models.inspiral import flux_model, get_p_at_t
    from ..models.waveform import default_frequencies, waveform_prologue
    from ..utils.device import resolve_device
    from ..utils.fdutils import get_fft_td_windowed

    dev = resolve_device(device if device is not None else torch.device("cuda", args.dev))
    timing = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    np.random.seed(args.seed)
    t_years, dt = args.Tobs, args.dt
    flux = args.flux
    phys_kwargs = physics(args)
    grid = None if flux == "pm" else flux_model(flux, dev)

    # fix p0 so the inspiral lasts 0.99 Tobs, through the templates' own flux
    tic = time.perf_counter()
    p0 = float(get_p_at_t(args.M, args.mu, args.e0, 0.99 * t_years, flux=flux, flux_grid=grid,
                          device=dev)[0])
    timing["p0_solve_s"] = time.perf_counter() - tic
    print(f"p0 fixed by duration solve: {p0:.6f}")

    table = default_mode_table(30)
    freq = default_frequencies(t_years, dt)
    f_pos = freq[freq > 0]
    ds = max(args.downsample, 1)
    f_np = f_pos[::ds]
    nf = len(f_np)

    kmax, max_steps, eps = args.kmax, args.max_steps, args.eps
    if args.freeze_selection:
        # freeze the eps selection at the injection point: every template
        # evaluates amplitudes and Ylm only for the kept slots
        pro_inj = waveform_prologue(
            args.M, args.mu, p0, args.e0, np.pi / 4, np.pi / 3, 1.0, 1.0, 2.0,
            t_years=t_years, table=table, k_max=kmax, eps=eps, max_steps=max_steps,
            flux_grid=grid, device=dev, **phys_kwargs,
        )
        forced = pro_inj.sel.idx[0].cpu().numpy()
        table_t = table.take(forced)
        idx_t = np.arange(len(forced))
        n_knots = int(pro_inj.n_live[0])
    else:
        table_t, idx_t, n_knots = table, None, None

    transform = parameter_transform()

    if args.template == "fd":
        template = fd_template(args, table_t, idx_t, f_np, flux_grid=grid, device=dev)
    else:
        # TD template: the dense TD waveform, DFT'd onto the downsampled grid
        from ..models.waveform import default_time_grid, td_waveform_core
        from ..utils.fdutils import dft_at_bins

        t_grid = torch.as_tensor(default_time_grid(t_years, dt), device=dev)
        n_t = t_grid.shape[0]
        # rfft bins matching f_np = freq[freq > 0][::ds]
        rfft_idx = np.arange(1, (n_t + 1) // 2)[::ds]
        prologue = template_prologue(args, table_t, idx_t, flux_grid=grid, device=dev)

        def template(params14):
            hp, hc = td_waveform_core(prologue(params14), table_t, t_grid)
            out = []
            for h in (hp, hc):
                re, im = dft_at_bins(h, rfft_idx, n_t)
                out.append((re * dt, im * dt))
            return out

    # ---- injection ----
    truth = np.array([np.log(args.M), np.log(args.mu / args.M), p0, args.e0, 1.0, 2.0])
    inj14 = transform.both_transforms(torch.as_tensor(truth[None]))
    sync()
    tic = time.perf_counter()
    chans = template(inj14)
    sync()
    timing["injection_s"] = time.perf_counter() - tic
    print(f"{args.template} injection time {timing['injection_s']:.3f}s on {nf} bins")
    data = [(re[0].double() + 1j * im[0].double()).cpu().numpy() for re, im in chans]

    if not args.injectFD:
        # TD injection FFT'd onto the downsampled grid (window optional)
        from ..models.waveform import GenerateEMRIWaveform

        td_gen = GenerateEMRIWaveform(
            sum_kwargs=dict(odd_len=True, flux=flux),
            amplitude_kwargs={k: phys_kwargs[k] for k in ("tail", "factorized", "rwz")},
            return_list=True, device=dev,
        )
        htd = td_gen(*inj14[0].tolist(), T=t_years, dt=dt, eps=eps)
        window = np.hanning(len(htd[0])) if args.window_flag else np.ones(len(htd[0]))
        fd_full = get_fft_td_windowed(htd, window, dt)
        data = [ch[freq > 0][::ds] for ch in fd_full]

    def noise_fn(f):
        return np.asarray(get_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd"))

    like = Likelihood(template, 2, f_arr=f_np, parameter_transforms=transform,
                      subset=args.subset, device=dev)
    like.inject_signal(data, noise_fn=noise_fn)
    inj_snr = snr(data, f_arr=f_np, PSD=noise_fn)
    print(f"injection SNR: {inj_snr:.2f}")

    # ---- priors / periodic ----
    priors = ProbDistContainer({
        0: uniform_dist(np.log(5e5), np.log(1e7)),
        1: uniform_dist(np.log(1e-6), np.log(1e-4)),
        2: uniform_dist(max(p0 - 2.0, 7.0), p0 + 3.0),
        3: uniform_dist(0.001, 0.7),
        4: uniform_dist(0.0, 2 * np.pi),
        5: uniform_dist(0.0, 2 * np.pi),
    })
    periodic = {"emri": {4: 2 * np.pi, 5: np.pi}}

    # ---- walkers around the truth ----
    rng = np.random.default_rng(args.seed)
    if args.start_cov:
        # (ndim, ndim) covariance or (N, ndim) samples, shrunk by 2.4 ndim
        arr = np.load(args.start_cov)
        cov = arr if arr.ndim == 2 and arr.shape[0] == arr.shape[1] else np.cov(arr.T)
        cov = cov / (2.4 * 6)
        start = rng.multivariate_normal(truth, cov, size=(args.ntemps, args.nwalkers))
        # walkers outside the prior are drawn again
        for _ in range(16):
            lp = priors.logpdf(start.reshape(-1, 6)).numpy().reshape(args.ntemps, args.nwalkers)
            bad = ~np.isfinite(lp)
            if not bad.any():
                break
            start[bad] = rng.multivariate_normal(truth, cov, size=int(bad.sum()))
    else:
        scales = np.abs(truth) * args.start_scale + 1e-9
        start = truth[None, None, :] + rng.normal(
            0, 1.0, (args.ntemps, args.nwalkers, 6)) * scales[None, None, :]

    outname = args.outname or (
        f"emri_pe_T{t_years}_M{args.M:.1e}_mu{args.mu}_e{args.e0}"
        f"_tmpl{args.template}_injFD{args.injectFD}_ds{ds}.h5"
    )
    if backend is None:
        from ..inference.backends.hdf import HDFBackend

        backend = HDFBackend(outname)
    resume = backend.initialized
    if resume:
        print(f"resuming from {outname} at iteration {backend.iteration}")

    sampler = EnsembleSampler(
        args.nwalkers, [6], lambda x: like(x), {"emri": priors},
        tempering_kwargs={"ntemps": args.ntemps, "Tmax": np.inf} if args.ntemps > 1 else None,
        periodic=periodic, backend=backend, branch_names=["emri"], info={"truth": truth},
        seed=args.seed,
    )
    initial = backend.get_last_sample() if resume else start
    tic = time.perf_counter()
    # the walkers' start is evaluated once, inside the wall as in the
    # reference, and timed apart from the steps
    initial = sampler._coerce_state(initial)
    sync()
    timing["start_s"] = time.perf_counter() - tic
    sampler.run_mcmc(initial, args.nsteps)
    sync()
    wall = time.perf_counter() - tic
    timing["sampling_s"] = wall
    timing["steps_s"] = wall - timing["start_s"]
    timing["evals_per_s"] = args.nsteps * args.ntemps * args.nwalkers / wall
    print(
        f"{args.nsteps} steps x {args.ntemps}x{args.nwalkers} walkers in {wall:.1f}s "
        f"({timing['evals_per_s']:.1f} posterior evals/s); "
        f"acceptance {np.mean(np.asarray(sampler.acceptance_fraction)):.3f}"
    )
    chain = sampler.get_chain()["emri"]
    if args.plot:
        from ..utils.plotting import plot_corner

        cold = chain[:, 0].reshape(-1, 6)
        cold = cold[~np.isnan(cold[:, 0])]
        png = outname.replace(".h5", "_corner.png")
        fig = plot_corner(cold, labels=["lnM", "ln(mu/M)", "p0", "e0", "Phi_phi0", "Phi_r0"],
                          truths=truth, fname=png)
        import matplotlib.pyplot as plt

        plt.close(fig)
        print(f"corner plot written to {png}")
    return {
        "chain": chain,
        "truth": truth,
        "snr": inj_snr,
        "backend": backend,
        "sampler": sampler,
        "likelihood": like,
        "data": data,
        "table": table_t,
        "forced_idx": idx_t,
        "f_arr": f_np,
        "flux_grid": grid,
        "noise_fn": noise_fn,
        "start": start,
        "p0": p0,
        "n_knots": n_knots,
        "timing": timing,
    }


def main(argv=None):
    run_emri_pe(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
