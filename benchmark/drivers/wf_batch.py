"""Traffic kind ``wf_batch``: a closed loop of B-walker batches of all-mode FD
waveforms through the program's batch module.

Each batch is a fresh draw from the seed: p0, e0, theta and phi uniform in
the traffic's jitter around the configuration's representative source. With
``traj_method`` "dp5" a batch is `FrozenFDWaveform.forward`; with "quad" it
is `waveform_prologue(traj_method="quad")` and `fd_waveform_core` on the
module's tables and offsets (as users reach it through the quadrature
trajectory). One batch of the seed's warm-up stream is set-up.

The configuration's flux table and frozen harmonics are handed to the
program (`common.program_flux_grid`, `common.program_table`); the window
offsets are the program's own, from its prologue at the representative
source.

The comparison: from each of the first ``keep_batches`` batches,
``keep_lanes`` lanes drawn from the seed are copied into a buffer allocated
in set-up; once the window has closed the reference computes their spectra
and the mean over the lanes of the worst channel's relative L2 distance is
compared (``spectra_rel_l2_mean``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import plain
from . import common


def _draw(rng, cfg, traffic, n) -> np.ndarray:
    """(n, 4) rows (p0, e0, theta, phi) uniform in the jitter's widths."""
    src, jit = cfg["representative_source"], traffic["jitter"]
    cols = [src[k] + jit[k] * (rng.random(n) - 0.5) for k in ("p0", "e0", "theta", "phi")]
    return np.stack(cols, axis=-1)


def setup(ctx):
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude, summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models import waveform as wf

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.dev
    phys = plain.physics(cfg)
    with ctx.stage("flux table"):
        grid = common.program_flux_grid(cfg, dev)
    with ctx.stage("offsets prologue"):
        f = wf.default_frequencies(cfg["t_years"], cfg["dt"])
        f = f[f > 0]
        nf, f0, df = len(f), float(f[0]), float(f[1] - f[0])
        table_k = common.program_table(cfg, amplitude)
        idx_k = np.arange(table_k.num_modes)
        src = cfg["representative_source"]
        one = (cfg["mass_1"], cfg["mass_2"], src["p0"], src["e0"], src["theta"], src["phi"],
               cfg["dist"], 0.0, 0.0)
        kw = dict(t_years=cfg["t_years"], k_max=table_k.num_modes, eps=0.0,
                  max_steps=cfg["max_steps"], flux_grid=grid, device=dev, **phys)
        pro0 = wf.waveform_prologue(*one, table=table_k, forced_idx=idx_k, **kw)
        offsets = wf.band_offsets_for(pro0, table_k, f0, df, cfg["bins_per_run"],
                                      cfg["band_runs"])
        gen = wf.FrozenFDWaveform(
            table_k, offsets, f0=f0, df=df, nf=nf, t_years=cfg["t_years"],
            mass_1=cfg["mass_1"], mass_2=cfg["mass_2"], dist=cfg["dist"],
            max_steps=cfg["max_steps"], bins_per_run=cfg["bins_per_run"],
            band_runs=cfg["band_runs"], turnover_slots=cfg["turnover_slots"],
            extra_band_runs=cfg["extra_band_runs"], flux_grid=grid, device=dev, **phys)
    method = traffic["traj_method"]
    n_b = traffic["batch"]

    def batch(rows: np.ndarray):
        p = torch.as_tensor(rows, dtype=torch.float64, device=dev)
        cols = [p[:, i].contiguous() for i in range(4)]
        if method == "dp5":
            return gen(*cols)
        masses = [torch.full_like(cols[0], cfg["mass_1"]), torch.full_like(cols[0], cfg["mass_2"])]
        pro = wf.waveform_prologue(
            *masses, *cols, cfg["dist"], 0.0, 0.0, t_years=cfg["t_years"], table=table_k,
            k_max=table_k.num_modes, eps=0.0, max_steps=cfg["max_steps"], forced_idx=idx_k,
            family_c=gen.family_c, flux_grid=gen.flux_grid(),
            rwz_rows=(gen.rwz_b_rows, gen.rwz_r_rows) if gen.rwz else None,
            traj_method="quad", **phys)
        return wf.fd_waveform_core(
            pro, table_k, nf, channels=True, uniform=(f0, df), band_runs=cfg["band_runs"],
            band_offsets=gen.band_offsets, bins_per_run=cfg["bins_per_run"],
            turnover_slots=cfg["turnover_slots"], extra_band_runs=cfg["extra_band_runs"],
            band_offsets_extra=gen.band_offsets_extra, out_f32=True)

    with ctx.stage("warm-up batch"):
        warm = np.random.default_rng([ctx.seed, 0])
        batch(_draw(warm, cfg, traffic, n_b))
        ctx.sync()
    n_keep = traffic["keep_lanes"] * traffic["keep_batches"]
    keep_buf = torch.zeros((n_keep, 4, nf), dtype=torch.float32, device=dev)
    ctx.harness_bytes = keep_buf.numel() * keep_buf.element_size()
    return dict(gen=gen, batch=batch, nf=nf, f0=f0, df=df, table=table_k, keep_buf=keep_buf,
                wf=wf, summation_fd=summation_fd)


def window(ctx, st) -> common.Window:
    cfg, traffic = ctx.cfg, ctx.traffic
    n_b, n_lanes = traffic["batch"], traffic["keep_lanes"]
    draws = np.random.default_rng([ctx.seed, 1])
    picks = np.random.default_rng([ctx.seed, 2])
    kept_rows, failed, first = [], [], []

    def step(i):
        rows = _draw(draws, cfg, traffic, n_b)
        if i == 0:
            first.append(rows)
        outs = st["batch"](rows)  # 4 x (B, nf): h+ re, im, hx re, im
        # a lane with a NaN or an infinity fails: max and min carry both
        bad = sum(~torch.isfinite(o.amax(dim=1)) | ~torch.isfinite(o.amin(dim=1)) for o in outs)
        failed.append((bad > 0).sum())
        if i < traffic["keep_batches"]:
            lanes = np.sort(picks.choice(n_b, size=n_lanes, replace=False))
            lanes_t = torch.as_tensor(lanes, device=ctx.dev)
            for c, o in enumerate(outs):
                st["keep_buf"][i * n_lanes:(i + 1) * n_lanes, c] = o[lanes_t]
            kept_rows.append(rows[lanes])

    with common.layer_spans(ctx, st["wf"], st["summation_fd"]):
        win = common.run_window(ctx, step, n_b)
    win.failed = int(sum(int(x) for x in failed))
    rows = np.concatenate(kept_rows)
    win.kept = dict(rows=rows, spectra=st["keep_buf"][:len(rows)].cpu(), first_batch=first[0],
                    offsets=st["gen"].band_offsets.cpu().numpy())
    return win


def truncation(ctx, st, rows: np.ndarray):
    """The program's spectra with the configured windows against whole-band
    windows (the same kernel with the band windows off), per lane: (worst
    lane, its value, lanes past 1e-4, lanes)."""
    cfg, wf, table, dev = ctx.cfg, st["wf"], st["table"], ctx.dev
    gen = st["gen"]
    vals = []
    for lo in range(0, len(rows), 32):
        p = torch.as_tensor(rows[lo:lo + 32], dtype=torch.float64, device=dev)
        pro = wf.waveform_prologue(
            cfg["mass_1"], cfg["mass_2"], *(p[:, i].contiguous() for i in range(4)), cfg["dist"],
            0.0, 0.0, t_years=cfg["t_years"], table=table, k_max=table.num_modes, eps=0.0,
            max_steps=cfg["max_steps"], forced_idx=np.arange(table.num_modes),
            family_c=gen.family_c, flux_grid=gen.flux_grid(),
            rwz_rows=(gen.rwz_b_rows, gen.rwz_r_rows) if gen.rwz else None,
            traj_method=ctx.traffic["traj_method"], **plain.physics(cfg))
        common_kw = dict(channels=True, uniform=(st["f0"], st["df"]),
                         bins_per_run=cfg["bins_per_run"], turnover_slots=cfg["turnover_slots"],
                         out_f32=True)
        banded = wf.fd_waveform_core(
            pro, table, st["nf"], band_runs=cfg["band_runs"], band_offsets=gen.band_offsets,
            extra_band_runs=cfg["extra_band_runs"], band_offsets_extra=gen.band_offsets_extra,
            **common_kw)
        whole = wf.fd_waveform_core(pro, table, st["nf"], **common_kw)
        vals.append(plain.lane_rel_l2(torch.stack(banded, 1).cpu().double().numpy(),
                                      torch.stack(whole, 1).cpu().double().numpy()))
        del pro, banded, whole
    v = np.concatenate(vals)
    return int(np.argmax(v)), float(v.max()), int((v > 1e-4).sum()), len(v)


def compare(ctx, kept, control=False) -> dict:
    """The number that decides `correct`: the mean over the kept lanes of
    the worst channel's relative L2 distance from the reference's spectra
    (``control``: the control's spectra in the program's place). The worst
    lane is printed beside it, and the window offsets, which the reference
    works out again, against the program's."""
    from ..lib.harness import log

    ref = plain.WaveformBatchReference(ctx.cfg)
    rows = np.asarray(kept["rows"])
    want = np.stack([ref.spectra(r) for r in rows])
    if control:
        ctl = plain.WaveformBatchReference(ctx.cfg, phase_dtype=np.float32)
        got = np.stack([ctl.spectra(r) for r in rows])
    else:
        got = kept["spectra"].double().numpy()
        same = int((np.asarray(kept["offsets"]) == ref.offsets).sum())
        log(f"[compare] window offsets equal to the reference's in {same} of "
            f"{len(ref.offsets)} slots")
    if not np.isfinite(got).all():
        return {"spectra_rel_l2_mean": float("inf")}
    rel = plain.lane_rel_l2(got, want)
    log(f"[compare] {'control' if control else 'program'}: {len(rel)} lanes, relative L2 mean "
        f"{float(rel.mean()):.4e}, median {float(np.median(rel)):.4e}, worst {float(rel.max()):.4e}")
    return {"spectra_rel_l2_mean": float(rel.mean())}
