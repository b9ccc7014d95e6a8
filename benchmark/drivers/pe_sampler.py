"""Traffic kind ``pe_sampler``: a closed loop of whole sampler steps of the
production PE run (`cli/emri_pe.py::run_emri_pe`'s flow with p0 fixed by the
configuration: no duration solve).

Set-up: the FD injection, the whitened likelihood, the tempered
stretch-move sampler with the in-memory backend, and the walkers' start
(one evaluation of the whole ensemble, drawn from the seed as the CLI draws
it: also the warm-up at the call shape). The configuration's flux table,
frozen harmonics and priors are handed to the program. The window:
`EnsembleSampler.sample`, one step at a time; each step is two likelihood
calls of ntemps x nwalkers / 2 rows (`Likelihood.__call__` ->
`fd_template` -> `waveform_prologue` (dp5) + `fd_waveform_core`).

The comparison: of the first ``keep_calls`` likelihood calls of the window,
``keep_rows`` rows each drawn from the seed keep their template and log L.
Once the window has closed the reference computes the templates of those
rows and of the injection: the mean over them of the template's relative
L2 distance (``template_rel_l2_mean``); the log L that the reference's
likelihood gives the program's own kept templates against the program's
own injection, against the program's log L of those rows, relative to
max(1, |log L|) (``loglike_consistency``: the likelihood stage by
itself); the share of walkers whose coordinates never left their start
(``unmoved_share``: a sampler whose steps return their state unchanged
reads 1); and the values of the window's first step that its replay from
the step's input state does not give (``move_replay_mismatch``,
`reference.stretch`). The gap between the program's log L and the
reference's end to end is printed beside them, not compared: the
template's errors shared by the injection cancel in it, so the control's
random phase errors read only 1.7-3.7 times the program's there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import plain
from . import common


def _argv(cfg) -> list[str]:
    """The PE command line the configuration stands for (the CLI's parser
    reads it, so the template takes the CLI's own settings)."""
    return [str(x) for x in (
        "-Tobs", cfg["Tobs"], "-M", cfg["M"], "-mu", cfg["mu"], "-p0", cfg["p0"],
        "-e0", cfg["e0"], "-dt", cfg["dt"], "-eps", cfg["eps"], "-downsample", cfg["downsample"],
        "-template", "fd", "-injectFD", 1, "-kmax", cfg["kmax"], "-max_steps", cfg["max_steps"],
        "-nwalkers", cfg["nwalkers"], "-ntemps", cfg["ntemps"], "--subset", cfg["subset"],
        "--start-scale", cfg["start_scale"], "-flux", cfg["physics"]["flux"],
        "-amp", cfg["physics"]["amp"])]


def setup(ctx):
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
    from emri_frequencydomainwaveforms_tpu_torch.inference.prior import (
        ProbDistContainer, uniform_dist)
    from emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood import Likelihood
    from emri_frequencydomainwaveforms_tpu_torch.lisa.sensitivity import get_sensitivity
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude, summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models import waveform as wf

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.dev
    args = emri_pe.build_parser().parse_args(_argv(cfg))
    inj = cfg["injection"]
    with ctx.stage("flux table"):
        grid = common.program_flux_grid(cfg, dev)
    table_t = common.program_table(cfg, amplitude)
    idx_t = np.arange(table_t.num_modes)
    f_np = wf.default_frequencies(args.Tobs, args.dt)
    f_np = f_np[f_np > 0][::max(args.downsample, 1)]
    rec = dict(keep=False, rows=None, offset=0, kept=[])
    template = emri_pe.fd_template(args, table_t, idx_t, f_np, flux_grid=grid, device=dev)

    def template_keeping(params14, bins=None):
        out = template(params14, bins)
        if rec["keep"]:
            lo, n = rec["offset"], params14.shape[0]
            rows = [r - lo for r in rec["call_rows"] if lo <= r < lo + n]
            if rows:
                sel = torch.as_tensor(rows, device=out[0][0].device)
                rec["kept"].append(torch.stack([x[sel] for pair in out for x in pair], dim=1))
            rec["offset"] = lo + n
        return out

    transform = emri_pe.parameter_transform()
    truth = np.array([np.log(args.M), np.log(args.mu / args.M), args.p0, args.e0,
                      inj["Phi_phi0"], inj["Phi_r0"]])
    with ctx.stage("injection"):
        chans = template(transform.both_transforms(torch.as_tensor(truth[None])))
        data = [(re[0].double() + 1j * im[0].double()).cpu().numpy() for re, im in chans]

    def noise_fn(f):
        return np.asarray(get_sensitivity(np.asarray(f), sens_fn=cfg["sens_fn"]))

    like = Likelihood(template_keeping, 2, f_arr=f_np, parameter_transforms=transform,
                      subset=args.subset, device=dev)
    like.inject_signal(data, noise_fn=noise_fn)
    priors = ProbDistContainer({i: uniform_dist(lo, hi) for i, (lo, hi) in enumerate(cfg["priors"])})
    calls = []

    def log_like(x):
        keep = rec["keep"]
        if keep:
            rec["offset"] = 0
            rec["call_rows"] = [r for r in rec["rows"] if r < x.shape[0]]
        ll = ctx.spans.wrap("likelihood", like)(x) if ctx.trace else like(x)
        calls.append((x.detach().to("cpu", torch.float64).clone(), ll.detach().clone(),
                      rec["call_rows"] if keep else None))
        return ll

    periods = {i: p for i, p in enumerate(cfg["periods"]) if p > 0}
    sampler = EnsembleSampler(
        args.nwalkers, [6], log_like, {"emri": priors},
        tempering_kwargs={"ntemps": args.ntemps, "Tmax": np.inf} if args.ntemps > 1 else None,
        periodic={"emri": periods}, backend=Backend(), branch_names=["emri"],
        info={"truth": truth}, seed=ctx.seed)
    rng = np.random.default_rng(ctx.seed)
    scales = np.abs(truth) * args.start_scale + 1e-9
    start = truth[None, None, :] + rng.normal(
        0, 1.0, (args.ntemps, args.nwalkers, 6)) * scales[None, None, :]
    with ctx.stage("walkers' start"):
        state = sampler._coerce_state(start)
        ctx.sync()
    calls.clear()
    return dict(sampler=sampler, state=state, start=start, calls=calls, rec=rec, args=args,
                data=np.stack([data[0].real, data[0].imag, data[1].real, data[1].imag]),
                wf=wf, summation_fd=summation_fd)


def window(ctx, st) -> common.Window:
    traffic, args, rec, calls = ctx.traffic, st["args"], st["rec"], st["calls"]
    picks = np.random.default_rng([ctx.seed, 2])
    n_rows = args.ntemps * args.nwalkers // 2
    gen = st["sampler"].sample(st["state"], iterations=1 << 30)
    last = {}

    def step(i):
        # the rows the next two calls keep, drawn before the step
        rec["keep"] = 2 * i < traffic["keep_calls"]
        rec["rows"] = sorted(picks.choice(n_rows, size=traffic["keep_rows"], replace=False))
        k0 = len(calls)
        last["state"] = next(gen)
        if i == 0:
            last["first"], last["first_calls"] = last["state"], calls[k0:]

    with common.layer_spans(ctx, st["wf"], st["summation_fd"]):
        win = common.run_window(ctx, step, args.ntemps * args.nwalkers)
    gen.close()
    rec["keep"] = False
    state = last["state"]
    rows_x, rows_ll = [], []
    for x, ll, rows in calls:
        if rows is not None:
            rows_x.append(x[rows])
            rows_ll.append(ll[torch.as_tensor(rows, device=ll.device)].cpu())
    final = state.branches[st["sampler"].branch_name].coords[:, :, 0, :].reshape(-1, 6)
    start = torch.as_tensor(st["start"]).reshape(-1, 6)
    unmoved = (final.cpu().double() == start).all(dim=1).double().mean()
    win.failed = int(sum(int((~torch.isfinite(ll)).sum()) for _, ll, _ in calls))
    before, after = st["state"], last["first"]
    branch = st["sampler"].branch_name
    first_step = dict(
        coords=before.branches[branch].coords[:, :, 0, :].cpu().double(),
        log_like=before.log_like.cpu().double(), betas=before.betas.cpu().double(),
        seed=before.random_state, calls=[(x, ll.cpu()) for x, ll, _ in last["first_calls"]],
        coords_after=after.branches[branch].coords[:, :, 0, :].cpu().double(),
        log_like_after=after.log_like.cpu().double(),
        bounds=ctx.cfg["priors"], periods=ctx.cfg["periods"])
    win.kept = dict(
        x=torch.cat(rows_x), ll=torch.cat(rows_ll), templates=torch.cat(rec["kept"]).cpu(),
        data=st["data"], unmoved_share=float(unmoved), first_step=first_step)
    return win


def compare(ctx, kept, control=False) -> dict:
    """The numbers that decide `correct` (see the module docstring;
    ``control``: the control's templates and injection in the program's
    place; the control has no sampler and no likelihood of its own, so it
    reads only ``template_rel_l2_mean``)."""
    from ..lib.harness import log
    from ..reference import stretch

    ref = plain.PEReference(ctx.cfg)
    x = kept["x"].numpy()
    want = np.concatenate([ref.data_w[None] / ref.white, ref.template(x)])
    if control:
        ctl = plain.PEReference(ctx.cfg, phase_dtype=np.float32)
        got = np.concatenate([ctl.data_w[None] / ctl.white, ctl.template(x)])
        got_ll = ctl.loglike(got[1:])
    else:
        got = np.concatenate([kept["data"][None], kept["templates"].double().numpy()])
        got_ll = kept["ll"].double().numpy()
    rel = plain.lane_rel_l2(got, want)
    dll = np.abs(got_ll - ref.loglike(want[1:]))
    log(f"[compare] {'control' if control else 'program'}: the injection and {len(x)} rows, "
        f"template relative L2 mean {float(rel.mean()):.4e}, worst {float(rel.max()):.4e} "
        f"(injection {float(rel[0]):.4e}); |log L - reference's| mean {float(dll.mean()):.4e}, "
        f"worst {float(dll.max()):.4e} (printed, not compared)")
    out = {"template_rel_l2_mean": float(rel.mean())}
    if not control:
        own = ref.loglike(got[1:], data=got[0])
        out["loglike_consistency"] = float(np.max(np.abs(got_ll - own) / np.maximum(1.0, np.abs(own))))
        out["unmoved_share"] = kept["unmoved_share"]
        out["move_replay_mismatch"] = float(stretch.mismatches(kept["first_step"]))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
