#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from the sources in this checkout (the
dense pass and the fixed-order row kernels, one nvcc each, at once),
checks the dense pass against its plain PyTorch version on the card at the
main path's shapes and on small adversarial layouts, then drives the port's main path
at full width: a 128-walker batch of all-mode FD waveforms of a 1-yr source
at dt = 10 s (1,577,907 positive bins), eps = 1e-2 selection frozen to 16
slots, 256-run windows of 64 bins and 2 turnover slots, the same module
once at B = 1 (the unbatched TPU kernel's path) and the batch once more with
the program's tracer on (equal to the bit, its counters held against the
kernel's count and the trajectory's knots). It does so twice: with the
flat physics (Peters-Mathews flux, plain multipole amplitudes) and with the
production physics (``flux="multipole_rwz"``, tail + factorized + rwz
amplitudes), whose flux grid it first builds on the card. On the production
path it then runs the reference benchmark's accuracy gates: the step budget
(gate 0), the frozen set's mode-power coverage (gate 1b), the banded kernel
against the general sorted-grid kernel and the window truncation (gate 1),
and a plunging source (gate 1c), then the FD/TD Hann mismatch (gate 2)
against the port's dense time-domain sum. Then it drives the
parameter-estimation path users run, `cli/emri_pe.py`'s `run_emri_pe` at
the production settings (1 yr, dt 10 s, downsample 100, rwz physics, kmax 48
frozen, 32 walkers x 4 temperatures, 3 sampler steps) with the in-memory
chain backend, and checks the zero residual at the injection, the stored
chain, one whitened walker batch against the plain dense pass and one
likelihood call with the program's tracer on against it off. Between
the two it drives the production batch again through the parallel-in-time
quadrature trajectory (``traj_method="quad"``: checks, the trajectory issued
with no host sync and equal to the CPU's, quad against dp5, and both
trajectories timed), runs `cli/check_mode_by_mode.py`'s TD-vs-FD scan for
one 1-yr draw, and the reference-signature facades (`EMRIInspiral`, the
Kerr `get_fundamental_frequencies` / `get_separatrix`) against the CPU.
After the gates it drives the data-driven amplitude backends on the rwz
batch's knots (`[backends]`: the Interp2D grid built on the card, a ROMAN
network trained on it) and the reference's Pallas-named FD entry points on
the batch's kernel inputs at full width (`[pallas-names]`); after the PE run,
the Fisher set on the PE template at the injection (`[fisher]`, card and
CPU), relative binning on a chirp (`[relbin]`), the sampler diagnostics
of the PE chain (`[diagnostics]`), the move library and the sampler's move
schedule on the PE likelihood from the PE chain's last state (`[moves]`),
the multi-branch / reversible-jump sampler on a two-source EMRI
`GlobalLikelihood` over the PE template (`[rj]`: tree stretch, prior-draw
RJ birth / death and tree swaps, then the lifted tree Gaussian and the
multiple-try RJ move), walker and frequency sharding on `torch.distributed`
(`[mesh]`: the PE likelihood at full width by 4 ranks of 4 walkers and on a
2 x 2 walker x frequency mesh against one process, every walker's knots,
log L and template, then the multi-rank dry run's chain against its
replay), and the TDI container and MLDC noise models on the PE injection
and grid (`[tdi]`). Then it holds the port to the reference test suite's
independent truths (`[truth]`, `testing/truth.py`: the golden cases against
the scipy SPA pipeline through the general kernel and, at 1 yr, the banded
path; a real fold against its brute-force integral through the general
kernel and the banded production kernel at runs of 16 bins with 4 turnover
slots; a plunging source's banded turnover against the general kernel).
Beside `[moves]`, a correctness phase whose times are not metrics, it runs
the port's three examples as a user runs them, each in a process of its own
(`[examples]`), and in one more process the root-level tools' torch twins
(`[tools]`, `tools_child`: gate 1's banded-vs-general ablation at full width
with the dense pass at runs of 64, 32 and 16 bins, the negative-frequency
survey's and the multipole-truncation study's per-source physics, the
calibrators' model sides and one held-out RWZ mode, each on the card
against the CPU, and the eccentric table re-cleaned from its raw solve).
From the end of `[scan]` to the kernel records, one more process runs the
reference's end-to-end run matrix on the paper source at full size
(`[matrix]`, `matrix_child`: `tools/torch_test_matrix.py`'s rows 1 and 3,
4 yr on the whole 6.3M-bin grid, 16 walkers, one step, the TD template and
the FD template against one windowed TD injection, from one duration
solve beside `[facades]` and `[pe]`, the rows after `[pe]`; the dense
pass at the new sizes against its plain version; where h5py imports, the
HDF chain file resumed for one more step).
Last it times the dense pass on the tables the runs produced, beside its
plain version, its byte bound, a zero fill of the same output (the practical
write floor) and the kernel with every slot dead, and each row kernel on
the inputs its call sites got in `[pe]`, beside its plain version and
bound. Every phase raises on failure; nothing falls back to the CPU or to
the plain version.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (``/usr/local/cuda``); imports no JAX. The
next-to-last line of output is the kernel record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

T_YEARS, DT = 1.0, 10.0
EPS = 1e-2
K_MAX = 16
MAX_STEPS = 192
BATCH = 128
BAND_RUNS = 256
BINS_PER_RUN = 64
TURNOVER_SLOTS = 2
EXTRA_BAND_RUNS = 64
KERNEL_SOURCE = "emri_frequencydomainwaveforms_tpu_torch/csrc/fd_dense.cu"
PALLAS = "emri_frequencydomainwaveforms_tpu/ops/pallas/fd_dense.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 peak outside the tensor cores (NVIDIA data sheet)
ROW_SOURCE = "emri_frequencydomainwaveforms_tpu_torch/csrc/row_ops.cu"
# float32 operations per kept (bin, slot) pair: 3 cubics + the cycle term +
# a sin/cos pair + 4 complex-weight multiply-adds (an FMA counts 2)
OPS_PER_PAIR = 64
CELL_BYTES = 4 * 4 + 3 * 4 + 8 * 4  # one (slot, run) cell of pc, nc and ec
SLOT_BYTES = 3 * 4 + 4 * 4  # one slot's i_lo, i_hi, g0 and w
SOURCE = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)  # the representative source
PLUNGING = (1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0)  # plunges at ~0.03 yr
RWZ = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)
COVERAGE_CHUNK = 16  # walkers per full-table amplitude evaluation in gate 1b
GATE2_TPU = (6.55e-5, 6.539e-5)  # FD/TD Hann mismatch (h+, hx), BENCH_r04.json: a TPU run
# cli/emri_pe.py at PE_VALIDATION.md's production settings, 3 sampler steps;
# --subset 64 keeps the 128-walker start evaluation at the step's batch size
PE_ARGS = ("-Tobs 1 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
           "-injectFD 1 -flux multipole_rwz -amp rwz -kmax 48 -nwalkers 32 -ntemps 4 "
           "-nsteps 3 --seed 2601996 --start-scale 1e-7 --subset 64")
PE_SNR_TPU = 57.1  # PE_VALIDATION.md, a TPU run
QUAD_LANES_CPU = 8  # lanes of the quad trajectory compared with the CPU
# the JAX package's quad-vs-dp5 distance, one lane of this batch's source at
# 1 yr (tests/test_torch_rwz.py::test_quad_vs_dp5_yardstick_reference, CPU)
QUAD_YARDSTICK = (5.3923e-05, 9.0083e-05)  # max |dPhi_phi| rad, FD rel L2
# cli/check_mode_by_mode.py at the paper's size for one draw
SCAN_ARGS = "-Tobs 1 -nsteps 1 -dt 10 -eps 1e-2 -downsample 100 --seed 2601996"
ROMAN_STEPS = 300  # Adam steps of 512 orbits in [backends]
# [backends] grid card vs CPU: float32 projections summed in another order;
# the port's and the JAX package's grids on the CPU differ by 1.36e-3 and
# 2.27e-5 in these two measures (tests/test_torch_backends.py)
GRID_L2_TOL, GRID_FROZEN_TOL = 5e-3, 1e-4
# [pallas-names] windows: the production 256 runs plus the 128-run slack the
# wrapper's rounding of the window starts asks for
PALLAS_RUNS = 384
# [fisher]: the sampled parameters (lnM, p0, e0, Phi_phi0), probe steps, and
# the stencil step as the share of the waveform's norm it moves
FISHER_PARAMS = (0, 2, 3, 4)
FISHER_PROBE = (1e-9, 1e-8, 1e-7, 1e-3)
FISHER_STEP = 0.1
# card vs CPU, each element against sqrt(Gamma_ii Gamma_jj): from a ~1e-5
# waveform agreement (phases to 1e-6 rad times m, the float32 dense pass to
# 1e-6), which the stencil divides by FISHER_STEP (x 0.95) and each element
# carries twice: ~2e-4, and 5x that. The card's and the CPU's dp5 templates
# differ by more (1.4e-4 rel L2 at the injection), but smoothly in the
# parameters, so the stencil cancels most of it
FISHER_TOL = 1e-3
RELBIN_WALKERS = 64
# [moves]: the PE configuration at full width with its ensemble cut to 16
# walkers x 2 temperatures (32 per likelihood call); the Gaussian widths of
# the parameters outside [fisher]'s block, as a share of each prior's width;
# stored vs fresh log L of the final walkers, relative: a walker's log L no
# longer depends on the batch it is evaluated in (ops/row_ops.py), so only
# float64 rounding is allowed
MOVES_WALKERS, MOVES_TEMPS = 16, 2
MOVES_WIDTH = 1e-7
MOVES_SEED = 2602
MOVES_LL_TOL = 1e-12
# [rj]: the PE configuration at full width, one "emri" branch of 1 or 2
# sources, the ensemble cut to 8 walkers x 2 temperatures; walkers 4-7 start
# with a second source drawn from the prior with this seed
RJ_WALKERS, RJ_TEMPS = 8, 2
RJ_SEED = 2603
# GlobalLikelihood against the PE Likelihood on the same rows in the same
# batch, relative (one source per group: the same arithmetic); each final
# stored log L against a fresh evaluation in another batch, relative (a
# walker's template and log L do not depend on its batch, ops/row_ops.py)
RJ_SAME_BATCH_TOL = 1e-12
RJ_FRESH_TOL = 1e-12
# [mesh]: the PE template at full width (no duration solve: p0 as the [pe]
# run solves it), 16 walkers evaluated in one process, by 4 ranks of 4
# walkers, on a 2 x 2 walker x frequency mesh and (walkers 0 and 5) alone;
# log L and the template against the batch of 16, relative
MESH_RANKS = 4
MESH_TOL = 1e-12
# [tdi]: card vs CPU and tensor vs numpy, relative
TDI_TOL = 1e-12
# [truth]: the golden cases of tests/test_golden_fd.py (mode, years) at its
# source (testing/truth_cases.py), each against the scipy SPA pipeline
TRUTH_GOLDEN = (((2, 2, 0), 0.25), ((2, 2, 3), 0.25), ((2, 2, -1), 0.25), ((2, 0, 3), 0.25),
                ((2, 2, 0), 1.0))
# [examples]: the port's examples, run as a user runs them (main(), no
# arguments: the current CUDA device, the default CI-quick sizes)
EXAMPLES = ("torch_quickstart", "torch_fd_construction", "torch_fd_waveforms_tutorial")


T_START = time.perf_counter()
_PHASE = [T_START]


def phase_done(name: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"[seconds] {name}: {now - _PHASE[0]:.1f} s", flush=True)
    _PHASE[0] = now


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events, warmed up)."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, torch):
    """Device time per call of ``fn``: the CUDA kernels' self time in a
    ``torch.profiler`` trace of ``reps`` calls (None if the trace shows no
    device time). Unlike `time_ms` it leaves out the host's issue time."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def device_trace(fn, torch):
    """One run of ``fn`` under ``torch.profiler`` (device activity only):
    its kernel launches, its copies and fills, the device's busy ms (the
    CUDA events' self time) and the traced run's wall ms on the host clock."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.count for e in on_card if e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(e.count for e in on_card) - copies
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    return kernels, copies, busy_ms, wall_ms


def host_us(fn, reps: int, torch) -> float:
    """Host time per call of ``fn`` (microseconds, host clock, no
    synchronize inside the loop): what a call costs the issuing thread."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def on_device(dense, groups, dev):
    return [dense.DenseGroup(*(x.to(dev) for x in g)) for g in groups]


def compare(torch, dense, cases, groups, r, nf, what):
    """Kernel vs plain version on the same tables: max |kernel - plain| and
    the plain output's max |.|; raises past 1e-5 max/scale, on a non-finite
    kernel output, or on a nonzero bin outside every kept band."""
    out_k = dense.fd_dense_accumulate(groups, r=r, nf=nf)
    out_p = dense.fd_dense_accumulate_reference(groups, r=r, nf=nf)
    torch.cuda.synchronize()
    check(out_k.shape == out_p.shape, f"{what}: kernel output shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), f"{what}: kernel output finite")
    outside = ~cases.kept_mask(groups, r, nf)[:, None, :].expand_as(out_k)
    check(not bool(out_k[outside].any()), f"{what}: exactly 0 outside every kept band")
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    check(err <= 1e-5 * scale, f"{what}: kernel vs plain {err:.3e} <= 1e-5 x {scale:.3e}")
    return err, scale


def bound(cases, groups, r, nf):
    """(ms, "bytes" | "operations"): the least time the card could take for
    this call, at the HBM peak for the bytes it must move or at the float32
    peak for the kept pairs' operations. The bytes: each coefficient cell
    that a kept bin inside the grid lies in, and each slot's scalars, read
    once; each output byte written once."""
    n_b = groups[0].pc.shape[0]
    n_bytes = (cases.kept_runs(groups, r, nf) * CELL_BYTES
               + sum(g.pc.shape[1] for g in groups) * n_b * SLOT_BYTES + n_b * 4 * nf * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = cases.kept_pairs(groups, r, nf) * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def dense_record(env, groups, r, nf, name, pallas_line, n_launched, reps):
    """The dense pass on one path's own tables: kernel against plain on the
    card (`compare`), then the kernel's CUDA-event and profiler times beside
    its plain version, a zero fill of the same output and its bound. Prints
    the [kernel] line and returns the kernel record."""
    torch, fd_dense, cases, card = env["torch"], env["fd_dense"], env["cases"], env["card"]
    n_b = groups[0].pc.shape[0]
    err, scale = compare(torch, fd_dense, cases, groups, r, nf, f"{name} real tables")
    ms = time_ms(lambda: fd_dense.fd_dense_accumulate(groups, r=r, nf=nf), reps, torch)
    plain_ms = time_ms(lambda: fd_dense.fd_dense_accumulate_reference(groups, r=r, nf=nf), 2,
                       torch)
    buf = fd_dense.output_buffer(n_b, nf, env["dev"])[0]
    zero_fill_ms = time_ms(buf.zero_, reps, torch)
    kernel_dev_ms = device_ms(lambda: fd_dense.fd_dense_accumulate(groups, r=r, nf=nf), reps,
                              torch)
    zero_dev_ms = device_ms(buf.zero_, reps, torch)
    bound_ms, bound_by = bound(cases, groups, r, nf)
    print(f"[kernel] {name} on the main path's tables, B={n_b} slots="
          f"{'+'.join(str(g.pc.shape[1]) for g in groups)} r={r} nf={nf} "
          f"({cases.kept_pairs(groups, r, nf)} kept bin-slot pairs in "
          f"{cases.kept_runs(groups, r, nf)} run cells): max|kernel-plain|="
          f"{err:.3e} (rel {err / scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"zero fill of the same (B, 4, {buf.shape[2]}) output {zero_fill_ms:.4f} ms "
          f"(practical write floor), bound {bound_ms:.4f} ms by {bound_by} -> "
          f"{100 * bound_ms / ms:.1f} % of bound; device time per call (profiler): kernel "
          f"{fmt(kernel_dev_ms)}, zero fill {fmt(zero_dev_ms)}; on {card}", flush=True)
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": f"{PALLAS}:{pallas_line}", "launches": n_launched,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "zero_fill_ms": zero_fill_ms,
        "device_ms": kernel_dev_ms, "tables": name.split("[")[1][:-1] if "[" in name else "flat",
    }


@contextlib.contextmanager
def patched(module, name, fn):
    """Replace ``module.name`` by ``fn`` for the duration."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def dense_function(summation_fd, fn):
    """Route the FD core's dense pass through ``fn`` for the duration."""
    return patched(summation_fd, "fd_dense_accumulate", fn)


def capturing(fn, seen):
    """``fn`` that also keeps each call's (groups, r, nf) in ``seen``."""
    def run(groups, *, r, nf):
        seen.append((groups, r, nf))
        return fn(groups, r=r, nf=nf)
    return run


def rel_l2(res, ref) -> float:
    """Worst channel's ||res - ref|| / ||ref|| of lane 0, in float64."""
    import torch
    return max(
        float(torch.linalg.vector_norm(o[0].double() - t[0].double())
              / torch.linalg.vector_norm(t[0].double()))
        for o, t in zip(res, ref)
    )


def drive_path(label, phys, env):
    """One physics configuration through the main path at full width.

    Selection prologue on the full table, the table sliced to the frozen
    slots, shared window offsets from the representative source, the
    128-walker batch and lane 0 alone through `FrozenFDWaveform`, the twin
    through the plain dense pass, the same module on the CPU, and the stage
    times. Returns what the later phases need.
    """
    torch, dev, card = env["torch"], env["dev"], env["card"]
    wf, fd_dense, summation_fd = env["wf"], env["fd_dense"], env["summation_fd"]
    table, batch, nf, f0u, dfu = env["table"], env["batch"], env["nf"], env["f0u"], env["dfu"]
    from emri_frequencydomainwaveforms_tpu_torch.utils import tracing
    amp_kw = {k: v for k, v in phys.items() if k != "flux"}
    flux = phys.get("flux", "pm")
    # no device named: the entry points run on the current CUDA device
    pro_sel = wf.waveform_prologue(
        *SOURCE, t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS, **phys
    )
    check(pro_sel.t_knots.device == dev, f"prologue on {pro_sel.t_knots.device} by default")
    forced_idx = pro_sel.sel.idx[0].cpu().numpy()
    table_k = table.take(forced_idx)
    idx_k = np.arange(len(forced_idx))
    pro0 = wf.waveform_prologue(
        *SOURCE, t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS,
        forced_idx=idx_k, **phys,
    )
    offsets = wf.band_offsets_for(pro0, table_k, f0u, dfu, BINS_PER_RUN, BAND_RUNS)
    gen = wf.FrozenFDWaveform(
        table_k, offsets, f0=f0u, df=dfu, nf=nf, t_years=T_YEARS, mass_1=1e6, mass_2=10.0,
        max_steps=MAX_STEPS, bins_per_run=BINS_PER_RUN, band_runs=BAND_RUNS,
        turnover_slots=TURNOVER_SLOTS, extra_band_runs=EXTRA_BAND_RUNS, **phys,
    )
    check(gen.lmn.device == dev, f"FrozenFDWaveform buffers on {gen.lmn.device} by default")
    if flux != "pm":
        check(gen.flux_values.device == dev and tuple(gen.flux_values.shape) == (96, 49, 2),
              "the module holds the (96, 49, 2) flux grid on the card")

    fd_dense.fd_dense_accumulate.launches = 0
    out = gen(*batch)
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    check(launches > 0, f"{label}: the main path launched the fd_dense kernel")
    check(all(o.shape == (BATCH, nf) and o.dtype == torch.float32 for o in out), "output shapes")
    # the same batch with the program's tracer on: the same outputs to the
    # bit, and every launch counted on a span
    tracing.reset()
    fd_dense.fd_dense_accumulate.launches = 0
    with tracing.enabled():
        out_on = gen(*batch)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, out_on)),
          f"{label}: the batch with tracing on equals it off, to the bit")
    by_span = sum(r.counters.get("fd_dense.launches", 0) for r in tracing.records())
    check(by_span == fd_dense.fd_dense_accumulate.launches == launches,
          f"{label}: fd_dense launches by span {by_span} = the kernel's count "
          f"{fd_dense.fd_dense_accumulate.launches} = {launches}")
    del out_on
    check(all(bool(torch.isfinite(o).all()) for o in out), f"{label}: all outputs finite")
    hp_abs = torch.hypot(out[0], out[1])
    nonzero = int((hp_abs > 0).sum(dim=1).min())
    peak = float(hp_abs.max())
    check(nonzero > 0, "every lane has nonzero bins")
    # |h~| ~ |A| / sqrt(fdot) at 1 Gpc for mu = 10 Msun: ~1e-18 1/Hz
    check(1e-21 < peak < 1e-15, f"peak |h+~| {peak:.3e} physically sane")

    # the B = 1 path (the unbatched TPU kernel's): lane 0 alone, through the kernel
    lane0 = [x[:1] for x in batch]
    fd_dense.fd_dense_accumulate.launches = 0
    single = gen(*lane0)
    torch.cuda.synchronize()
    launches_1 = fd_dense.fd_dense_accumulate.launches
    check(launches_1 > 0, f"{label}: the B = 1 path launched the fd_dense kernel")
    check(all(bool(torch.isfinite(o).all()) for o in single), f"{label}: B = 1 outputs finite")
    # lane 0 against its twin through the plain dense pass, on the card
    tables_1 = []
    with dense_function(summation_fd,
                        capturing(fd_dense.fd_dense_accumulate_reference, tables_1)):
        twin = gen(*lane0)
    rel, rel_1 = rel_l2(out, twin), rel_l2(single, twin)
    check(rel <= 1e-5, f"{label}: lane 0 vs plain-dense twin rel L2 {rel:.3e} <= 1e-5")
    check(rel_1 <= 1e-5, f"{label}: B = 1 run vs plain-dense twin rel L2 {rel_1:.3e} <= 1e-5")
    # lane 0 against the same module on the CPU (plain paths throughout)
    host = gen.to("cpu")(*(x.cpu() for x in lane0))
    gen.to(dev)
    rel_cpu = rel_l2([o.cpu() for o in out], host)
    check(rel_cpu <= 1e-4, f"{label}: lane 0 GPU vs CPU rel L2 {rel_cpu:.3e} <= 1e-4")

    # ---- timing (informational) ----
    del twin, host, hp_abs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        gen(*batch)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / 3
    stage = {}
    grid = gen.flux_grid()
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    with tracing.enabled():
        traj = env["inspiral"].schwarz_ecc_flux_inspiral(
            1e6, 10.0, batch[0], batch[1], t_years=T_YEARS, max_steps=MAX_STEPS, flux=flux,
            flux_grid=grid)
    torch.cuda.synchronize()
    stage["trajectory"] = time.perf_counter() - t0
    max_knots = int(traj.n.max())
    dp5 = tracing.totals()
    check(dp5["dp5.accepted"] == int(traj.n.sum()) - BATCH
          and dp5["dp5.accepted"] + dp5["dp5.rejected"] <= dp5["dp5.lane_slots"]
          == BATCH * dp5["dp5.trips"],
          f"{label}: dp5 counters {dp5} hold against the knots (sum n {int(traj.n.sum())})")
    rows = (gen.rwz_b_rows, gen.rwz_r_rows) if gen.rwz else None
    t0 = time.perf_counter()
    env["amplitude"].mode_amplitudes(traj.p, traj.e, table_k, family_c=gen.family_c,
                                     rwz_rows=rows, **amp_kw)
    torch.cuda.synchronize()
    stage["amplitudes"] = time.perf_counter() - t0
    pro = wf.waveform_prologue(
        1e6, 10.0, *batch, 1.0, 0.0, 0.0, t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS,
        max_steps=MAX_STEPS, forced_idx=idx_k, family_c=gen.family_c, flux_grid=grid,
        rwz_rows=rows, **phys,
    )
    dense_s = []
    tables = []

    def timed_dense(groups_, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fd_dense.fd_dense_accumulate(groups_, **kw)
        torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t1)
        return res

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dense_function(summation_fd, capturing(timed_dense, tables)):
        wf.fd_waveform_core(
            pro, table_k, nf, channels=True, uniform=(f0u, dfu), band_runs=BAND_RUNS,
            band_offsets=gen.band_offsets, bins_per_run=BINS_PER_RUN,
            turnover_slots=TURNOVER_SLOTS, extra_band_runs=EXTRA_BAND_RUNS,
            band_offsets_extra=gen.band_offsets_extra, out_f32=True,
        )
    torch.cuda.synchronize()
    stage["dense pass"] = dense_s[0]
    stage["splines + level-1"] = time.perf_counter() - t0 - dense_s[0]
    print(f"[{label}] B={BATCH} nf={nf} slots={len(forced_idx)}+{TURNOVER_SLOTS}: finite, "
          f"fd_dense launches={launches}, min nonzero bins/lane={nonzero}, peak |h+~|={peak:.4e}, "
          f"max_knots={max_knots}, lane0 vs plain-dense twin rel L2={rel:.3e}, "
          f"lane0 vs CPU port rel L2={rel_cpu:.3e}; B=1 run: fd_dense launches={launches_1}, "
          f"vs plain-dense twin rel L2={rel_1:.3e}; tracing on: the batch equal to the bit, "
          f"fd_dense launches by span = the kernel's count; the trajectory's dp5 trips "
          f"{dp5['dp5.trips']}, accepted {dp5['dp5.accepted']} (= sum n - B), rejected "
          f"{dp5['dp5.rejected']}, of {dp5['dp5.lane_slots']} lane slots", flush=True)
    print(f"[timing {label}] {BATCH / per_batch:.2f} waveforms/s ({per_batch * 1e3:.1f} ms per "
          f"{BATCH}-walker batch, host clock, synchronized); stages (ms): "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stage.items())
          + f"; on {card}", flush=True)
    return dict(gen=gen, table_k=table_k, forced_idx=forced_idx, pro=pro, out=out, traj=traj,
                single=single, launches=launches, launches_1=launches_1,
                tables=tables[0], tables_1=tables_1[0], max_knots=max_knots)


def mismatch(a, b) -> float:
    """1 - |<a, b>| / sqrt(<a, a><b, b>) of two complex numpy vectors."""
    num = np.abs(np.vdot(a, b))
    return float(1.0 - num / np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real))


def band_edge_mask(wf, pro, tbl, f_at, dfu, edge_runs=2.0, bins_per_run=BINS_PER_RUN):
    """True where ``f_at`` lies within ``edge_runs`` runs (of ``bins_per_run``
    bins of ``dfu``) of a live mode band's start, termination or maximum
    (lane 0): there the banded kernel's level-1 nodes anchor against
    extrapolated t(f) while the general kernel reads the time spline
    directly, a localized disagreement the gates report apart from the
    rest."""
    fphi_k, fr_k = wf.knot_frequencies(pro)
    sel_i = pro.sel.idx[0].cpu().numpy()
    live_m = pro.sel.mask[0].cpu().numpy().astype(bool)
    nl = int(pro.n_live[0])
    fk = (tbl.ms[sel_i].astype(float)[:, None] * fphi_k[None, :nl]
          + tbl.ns[sel_i].astype(float)[:, None] * fr_k[None, :nl])
    edges = np.concatenate([fk[live_m][:, 0], fk[live_m][:, -1], fk[live_m].max(axis=1)])
    d = np.min(np.abs(f_at[:, None] - edges[None, :]), axis=1)
    return d < edge_runs * bins_per_run * dfu


def split_rel_l2(banded, general, sub, is_edge):
    """Worst channel's RMS of (banded[sub] - general) / RMS(banded[sub]),
    over the bins off the edges, on them, and over all of them."""
    off = on = full = 0.0
    for b_full, g_sub in zip(banded, general):
        b_sub = b_full[0].double().cpu().numpy()[sub]
        err = (b_sub - g_sub[0].double().cpu().numpy()) / (np.sqrt(np.mean(b_sub**2)) + 1e-300)
        full = max(full, float(np.sqrt(np.mean(err**2))))
        off = max(off, float(np.sqrt(np.mean(err[~is_edge] ** 2))))
        if is_edge.any():
            on = max(on, float(np.sqrt(np.mean(err[is_edge] ** 2))))
    return off, on, full


def drive_pe(env):
    """`run_emri_pe` at the production settings, with its checks and times.

    Counts the dense-pass launches of the whole run (duration solve,
    injection, the walkers' start, 3 sampler steps) and keeps the tables of
    its first B = 1 call (the injection) and its first batched call (a
    stretch half-step). The row kernels' launches by call site and the
    stage split of one likelihood call are the program's own counters and
    spans (`utils.tracing`). Returns the tables with the launch counts.
    """
    torch, dev, card = env["torch"], env["dev"], env["card"]
    wf, fd_dense, summation_fd = env["wf"], env["fd_dense"], env["summation_fd"]
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.lisa import likelihood as lisa_likelihood
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude, geodesic
    from emri_frequencydomainwaveforms_tpu_torch.ops import row_ops
    from emri_frequencydomainwaveforms_tpu_torch.utils import tracing

    args = emri_pe.build_parser().parse_args(PE_ARGS.split())
    seen = {}
    row_kernels = (row_ops.row_sum, row_ops.row_cumsum)
    # each row kernel's call sites on the PE path: (module, name, site, the
    # program's spans around it; the geodesic's sums run in the trajectory's
    # RHS and in the mode selection's frequencies)
    row_sites = ((geodesic, "row_sum", "row_sum[rhs]", ("trajectory.dp5", "selection")),
                 (amplitude, "row_sum", "row_sum[amplitudes]", ("amplitudes",)),
                 (lisa_likelihood, "row_sum", "row_sum[likelihood]", ("likelihood.power",)),
                 (summation_fd, "row_cumsum", "row_cumsum[level-1]", ("core.level1",)))
    row_inputs = {}

    def at_sites():
        """Patch every call site to keep its first inputs."""
        stack = contextlib.ExitStack()
        for module, name, site, _ in row_sites:
            def run(*a, _fn=getattr(module, name), _site=site, **k):
                if _site not in row_inputs:
                    row_inputs[_site] = (_fn, tuple(t.clone() for t in a), dict(k))
                return _fn(*a, **k)
            stack.enter_context(patched(module, name, run))
        return stack

    def keep_first(groups, *, r, nf):
        n_b = groups[0].pc.shape[0]
        key = "tables_1" if n_b == 1 else "tables"
        seen.setdefault(key, (groups, r, nf))
        seen[key + "_calls"] = seen.get(key + "_calls", 0) + 1
        return fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)

    fd_dense.fd_dense_accumulate.launches = 0
    for fn in row_kernels:
        fn.launches = 0
    tracing.reset()
    with dense_function(summation_fd, keep_first), tracing.enabled():
        out = emri_pe.run_emri_pe(args, backend=Backend())
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    row_launches = {fn.__name__: fn.launches for fn in row_kernels}
    # each launch the program counted, by kernel and innermost span
    by_span = {}
    for rec in tracing.records():
        for key, n in rec.counters.items():
            if key.endswith(".launches"):
                site = f"{key[:-len('.launches')]}[{rec.name}]"
                by_span[site] = by_span.get(site, 0) + n
    row_launches_sites = {site: sum(by_span.get(f"{name}[{span}]", 0) for span in spans)
                          for _, name, site, spans in row_sites}
    declared = {f"{name}[{span}]" for _, name, _, spans in row_sites for span in spans}
    row_keys = {k for k in by_span if k.split("[")[0] in row_launches}
    check(row_keys <= declared and all(
              sum(by_span[k] for k in row_keys if k.startswith(name + "[")) == n
              for name, n in row_launches.items()),
          f"[pe] every row kernel launch came from a call site ({by_span})")
    n_1, n_b = seen.get("tables_1_calls", 0), seen.get("tables_calls", 0)
    check(launches > 0 and launches == n_1 + n_b,
          f"[pe] the PE run launched the fd_dense kernel ({launches} = {n_1} + {n_b})")
    check(all(v > 0 for v in row_launches_sites.values()),
          f"[pe] the PE run launched every row kernel from each of its call sites "
          f"({row_launches_sites})")
    check(n_1 >= 1 and n_b >= 2 * args.nsteps, f"[pe] B = 1 calls {n_1}, batched calls {n_b}")
    like, backend, timing = out["likelihood"], out["backend"], out["timing"]

    # the zero residual at the injection, the chain, the acceptance
    ll_truth = float(like(out["truth"][None])[0])
    check(abs(ll_truth) < 1e-3, f"[pe] |log L(truth)| {abs(ll_truth):.3e} < 1e-3")
    check(np.isfinite(out["snr"]), f"[pe] injection SNR {out['snr']} finite")
    ll = backend.get_log_like()
    chain = out["chain"]
    check(ll.shape == (args.nsteps, args.ntemps, args.nwalkers), f"[pe] log_like {ll.shape}")
    check(chain.shape == (args.nsteps, args.ntemps, args.nwalkers, 1, 6), f"[pe] chain {chain.shape}")
    check(bool(np.isfinite(ll).all() and (ll > -1e300).all()), "[pe] every stored log L finite")
    check(bool(np.isfinite(chain).all()), "[pe] chain finite")
    acc = np.asarray(backend.acceptance_fraction)
    check(bool(((acc >= 0) & (acc <= 1)).all()), f"[pe] acceptance {acc.mean()} in [0, 1]")

    # one walker batch (a stretch half-step's 64 walkers): whitened
    # template through the kernel vs through the plain dense pass
    half = torch.as_tensor(chain[-1, :, : args.nwalkers // 2, 0, :].reshape(-1, 6))
    w_k = like._channels(half)
    with dense_function(summation_fd, fd_dense.fd_dense_accumulate_reference):
        w_p = like._channels(half)
    torch.cuda.synchronize()
    rel_w = max(
        float((torch.linalg.vector_norm(a - b, dim=-1) / torch.linalg.vector_norm(b, dim=-1)).max())
        for pk, pp in zip(w_k, w_p) for a, b in zip(pk, pp)
    )
    check(rel_w <= 1e-5, f"[pe] whitened template kernel vs plain rel L2 {rel_w:.3e} <= 1e-5")
    del w_k, w_p

    # one 64-walker likelihood call, split by the program's spans; the first
    # input of each row-kernel call site is kept for the kernel records, and
    # the inputs of its level-1 tables (the main slots)
    level1_in = []

    def level1_keeping(*a, **k):
        if not level1_in:
            level1_in.append((a, k))
        return chunks(*a, **k)

    chunks = summation_fd._level1_walker_chunks
    with patched(summation_fd, "_level1_walker_chunks", level1_keeping), at_sites():
        tracing.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.enabled():
            ll_on = like(half)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    ll_off = like(half)
    check(torch.equal(ll_on, ll_off),
          "[pe] the likelihood call with tracing on equals it off, to the bit")
    stage_ms = {}
    for rec in tracing.records():
        stage_ms[rec.name] = stage_ms.get(rec.name, 0.0) + (rec.end_ns - rec.start_ns) * 1e-6
    rest = call_s * 1e3 - sum(stage_ms.get(k, 0.0) for k in (
        "trajectory.dp5", "amplitudes", "core.level1", "core.dense"))
    # what the level-1 walker chunks cost this call: its main slots' tables
    # in chunks (as the call ran them) and in one pass, alternated
    l1_a, l1_k = level1_in[0]
    n_w, n_s, n_nodes = l1_a[3].shape[0], l1_a[3].shape[1], l1_a[12]
    step = max(1, summation_fd._LEVEL1_NODES // (n_s * n_nodes))
    sizes = [min(step, n_w - b) for b in range(0, n_w, step)]
    check(all(torch.equal(x, y) for x, y in zip(
        chunks(*l1_a, **l1_k), summation_fd._level1_uniform_tables(*l1_a, **l1_k))),
        "[pe] level-1 tables in walker chunks equal one pass, to the bit")
    l1_ms = {"chunks": [], "one pass": []}
    for _ in range(2):
        l1_ms["chunks"].append(time_ms(lambda: chunks(*l1_a, **l1_k), 2, torch))
        l1_ms["one pass"].append(
            time_ms(lambda: summation_fd._level1_uniform_tables(*l1_a, **l1_k), 2, torch))
    del level1_in, l1_a, l1_k
    torch.cuda.empty_cache()
    step_s = timing["steps_s"] / args.nsteps
    acc_mean = float(acc.mean())
    print(f"[pe] run_emri_pe ({PE_ARGS}): p0 {out['p0']:.6f}, injection SNR {out['snr']:.2f} "
          f"(the TPU's PE_VALIDATION.md run: {PE_SNR_TPU}), |log L(truth)| {abs(ll_truth):.3e}, "
          f"stored log L in [{ll.min():.4e}, {ll.max():.4e}], acceptance {acc_mean:.3f}, "
          f"fd_dense launches {launches} ({n_1} at B = 1, {n_b} batched), row kernel launches "
          f"{row_launches} (by call site {row_launches_sites}; by the program's innermost span "
          f"{by_span}), whitened template kernel vs "
          f"plain rel L2 {rel_w:.3e}", flush=True)
    print(f"[timing pe] duration solve {timing['p0_solve_s']:.2f} s; injection "
          f"{timing['injection_s'] * 1e3:.1f} ms; one {half.shape[0]}-walker likelihood call "
          f"{call_s * 1e3:.1f} ms, synchronized (the program's spans, host ms, not synchronized: "
          f"trajectory {stage_ms.get('trajectory.dp5', 0.0):.1f}, amplitudes "
          f"{stage_ms.get('amplitudes', 0.0):.1f}, level-1 tables "
          f"{stage_ms.get('core.level1', 0.0):.1f}, dense {stage_ms.get('core.dense', 0.0):.1f}, "
          f"the rest (Ylm, splines, whitening, the wait for the device) {rest:.1f}; splines "
          f"{stage_ms.get('core.prepare', 0.0):.1f}, whitened residual "
          f"{stage_ms.get('likelihood.power', 0.0):.1f}); the walkers' start (one "
          f"{args.ntemps * args.nwalkers}-walker evaluation) {timing['start_s']:.2f} s; one sampler "
          f"step {step_s:.2f} s (the {args.nsteps} steps' wall / {args.nsteps}); "
          f"{timing['evals_per_s']:.2f} posterior evaluations/s "
          f"(nsteps x ntemps x nwalkers / the steps' wall, the walkers' start left out); "
          f"host clock; on {card}", flush=True)
    print(f"[timing pe] level-1 tables of that call's main slots ({n_w} walkers x {n_s} slots x "
          f"{n_nodes} nodes): in walker chunks of {' + '.join(map(str, sizes))} (at most "
          f"{summation_fd._LEVEL1_NODES} nodes, as the call ran them) "
          f"{' / '.join(f'{t:.1f}' for t in l1_ms['chunks'])} ms, in one pass "
          f"{' / '.join(f'{t:.1f}' for t in l1_ms['one pass'])} ms (CUDA events, two alternated "
          f"pairs of 2 calls each); the same tables to the bit; on {card}", flush=True)
    return dict(tables=seen["tables"], tables_1=seen["tables_1"], launches=n_b, launches_1=n_1,
                args=args, out=out, row_launches=row_launches_sites, row_inputs=row_inputs)


def lane_rel_l2(res, ref):
    """Per lane, the worst channel's ||res - ref|| / ||ref||, float64."""
    import torch
    return torch.stack([
        torch.linalg.vector_norm(o.double() - t.double(), dim=-1)
        / torch.linalg.vector_norm(t.double(), dim=-1)
        for o, t in zip(res, ref)
    ]).max(dim=0).values


def drive_quad(env, rwz):
    """The production batch of phase 6 through the quadrature trajectory.

    The same 128 walkers, frozen slots, windows and physics, through
    `waveform_prologue(traj_method="quad")` and `fd_waveform_core`; checks
    the batch, the kernel on its tables, the trajectory against the same
    function on the CPU and the sync-free issue of the trajectory; prints
    quad against dp5 at full width; runs the JAX package's own quad-vs-dp5
    check (tests/test_trajectory.py:327-370) on the card; times the two
    trajectories. Returns the kernel's tables and launches.
    """
    torch, dev, card = env["torch"], env["dev"], env["card"]
    wf, fd_dense, summation_fd = env["wf"], env["fd_dense"], env["summation_fd"]
    inspiral, amplitude = env["inspiral"], env["amplitude"]
    batch, nf, f0u, dfu = env["batch"], env["nf"], env["f0u"], env["dfu"]
    gen, table_k, forced_idx = rwz["gen"], rwz["table_k"], rwz["forced_idx"]
    idx_k = np.arange(len(forced_idx))
    grid = gen.flux_grid()
    rows = (gen.rwz_b_rows, gen.rwz_r_rows)
    masses = [torch.full_like(batch[0], 1e6), torch.full_like(batch[0], 10.0)]

    def batch_fd(method, dense=fd_dense.fd_dense_accumulate):
        pro = wf.waveform_prologue(
            *masses, *batch, 1.0, 0.0, 0.0, t_years=T_YEARS, table=table_k, k_max=K_MAX,
            eps=EPS, max_steps=MAX_STEPS, forced_idx=idx_k, family_c=gen.family_c,
            flux_grid=grid, rwz_rows=rows, traj_method=method, **RWZ)
        with dense_function(summation_fd, dense):
            out = wf.fd_waveform_core(
                pro, table_k, nf, channels=True, uniform=(f0u, dfu), band_runs=BAND_RUNS,
                band_offsets=gen.band_offsets, bins_per_run=BINS_PER_RUN,
                turnover_slots=TURNOVER_SLOTS, extra_band_runs=EXTRA_BAND_RUNS,
                band_offsets_extra=gen.band_offsets_extra, out_f32=True)
        return pro, out

    # phase 6's dp5 batch: its FD output and its prologue on the same slots
    out_d, pro_d = rwz["out"], rwz["pro"]
    tables = []
    fd_dense.fd_dense_accumulate.launches = 0
    pro_q, out_q = batch_fd("quad", capturing(fd_dense.fd_dense_accumulate, tables))
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    check(launches > 0, "[quad] the quad batch launched the fd_dense kernel")
    check(all(o.shape == (BATCH, nf) and bool(torch.isfinite(o).all()) for o in out_q),
          "[quad] every output finite")
    check(bool((pro_q.n_live == MAX_STEPS).all()), f"[quad] every lane has n == {MAX_STEPS}")
    check(bool((torch.diff(pro_q.t_knots, dim=-1) > 0).all()), "[quad] t strictly increasing")
    err, scale = compare(torch, fd_dense, env["cases"], *tables[0], "[quad] batch tables")

    # the trajectory issues no host sync: every input already on the card
    # (a Python scalar argument would be copied over, which synchronizes),
    # CUDA's sync debug mode raising on any synchronizing call
    zeros = torch.zeros_like(batch[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj_q = inspiral.schwarz_ecc_flux_inspiral(
            *masses, batch[0], batch[1], t_years=T_YEARS, Phi_phi0=zeros, Phi_r0=zeros,
            max_steps=MAX_STEPS, flux="multipole_rwz", flux_grid=grid, method="quad")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the card against the same function on the CPU, over the card's grid
    lanes = slice(0, QUAD_LANES_CPU)
    grid_cpu = grid._replace(values=grid.values.cpu())
    traj_c = inspiral.schwarz_ecc_flux_inspiral(
        1e6, 10.0, batch[0][lanes].cpu(), batch[1][lanes].cpu(), t_years=T_YEARS,
        max_steps=MAX_STEPS, flux="multipole_rwz", flux_grid=grid_cpu, method="quad")
    worst = {}
    for name in ("t", "p", "e", "Phi_phi", "Phi_r"):
        a, b = getattr(traj_q, name)[lanes].cpu(), getattr(traj_c, name)
        diff = float((a - b).abs().max())
        worst[name] = diff if name.startswith("Phi") else diff / float(b.abs().max())
    check(all(worst[k] <= 1e-9 for k in ("t", "p", "e")) and
          all(worst[k] <= 1e-6 for k in ("Phi_phi", "Phi_r")),
          f"[quad] card vs CPU on {QUAD_LANES_CPU} lanes: {worst}")

    # quad against dp5 at full width (printed, not gated)
    rel_np = lane_rel_l2(out_q, out_d).cpu().numpy()
    # |dPhi_phi| at each lane's live dp5 knots inside quad's span, from a
    # not-a-knot spline of quad's phase (all lanes at once)
    sp = env["cubic_spline"].fit_cubic_spline(pro_q.t_knots, pro_q.phi_phi, bc="not-a-knot")
    live = ((torch.arange(MAX_STEPS, device=dev)[None, :] < pro_d.n_live[:, None])
            & (pro_d.t_knots <= pro_q.t_knots[:, -1:]))
    gap = (env["cubic_spline"].spline_eval(sp, pro_d.t_knots) - pro_d.phi_phi).abs()
    dphi = torch.where(live, gap, 0.0).max(dim=-1).values.cpu().numpy()
    p0s, e0s = (x.cpu().numpy() for x in batch[:2])
    worst_lanes = "; ".join(
        f"largest {what}: lane {i} (p0 {p0s[i]:.6f}, e0 {e0s[i]:.6f}) FD rel L2 {rel_np[i]:.4e}, "
        f"|dPhi_phi| {dphi[i]:.4e} rad"
        for what, i in (("FD rel L2", int(np.argmax(rel_np))), ("|dPhi_phi|", int(np.argmax(dphi)))))
    print(f"[quad] B={BATCH} rwz batch through traj_method='quad' (n = {MAX_STEPS} knots in "
          f"every lane, t strictly increasing): finite, fd_dense launches={launches}, kernel vs "
          f"plain on its tables max|kernel-plain|={err:.3e} (rel {err / scale:.3e}), 0 outside the "
          f"bands; card vs CPU on {QUAD_LANES_CPU} lanes: t {worst['t']:.3e}, p {worst['p']:.3e}, "
          f"e {worst['e']:.3e} (relative, <= 1e-9), Phi_phi {worst['Phi_phi']:.3e}, Phi_r "
          f"{worst['Phi_r']:.3e} rad (<= 1e-6); no host sync in the trajectory (CUDA sync debug "
          f"mode 'error'); quad vs dp5 over the batch: FD rel L2 max {rel_np.max():.4e} median "
          f"{np.median(rel_np):.4e}, |dPhi_phi| at dp5's knots max {dphi.max():.4e} median "
          f"{np.median(dphi):.4e} rad (the JAX package's own at one lane of this source on the "
          f"CPU: {QUAD_YARDSTICK[1]:.4e}, {QUAD_YARDSTICK[0]:.4e} rad); {worst_lanes}", flush=True)
    del out_d, pro_d, traj_q, traj_c, rwz["out"], rwz["pro"]

    # the JAX package's own check, on the card: PM flux, 0.1 yr, l <= 2,
    # k_max 8, dp5 at 256 knots against quad at 128, the set pinned to dp5's
    table8 = amplitude.default_mode_table(8, l_max=2)
    freq8 = wf.default_frequencies(0.1, DT)
    f8 = freq8[freq8 > 0]
    uni8 = (float(f8[0]), float(f8[1] - f8[0]))
    params = (1e6, 50.0, 12.0, 0.4, 0.7, 0.5, 1.0, 0.0, 0.0)
    kw8 = dict(t_years=0.1, table=table8, k_max=8, eps=1e-2)
    forced8 = wf.waveform_prologue(*params, max_steps=256, **kw8).sel.idx[0].cpu().numpy()
    outs8 = {}
    for method, msteps in (("dp5", 256), ("quad", 128)):
        pro8 = wf.waveform_prologue(*params, forced_idx=forced8, max_steps=msteps,
                                    traj_method=method, **kw8)
        outs8[method] = wf.fd_waveform_core(pro8, table8, len(f8), channels=True, uniform=uni8)
    rms = max(float(torch.sqrt(torch.mean((a - b) ** 2)) / torch.sqrt(torch.mean(a**2)))
              for a, b in zip(outs8["dp5"], outs8["quad"]))
    print(f"[quad] the JAX package's own check on the card (tests/test_trajectory.py:327-370: PM, "
          f"0.1 yr, l <= 2, k_max 8, dp5 at 256 vs quad at 128): rel L2 {rms:.4e} (< 1e-3)",
          flush=True)
    check(rms < 1e-3, f"[quad] PM 0.1-yr quad vs dp5 rel L2 {rms:.3e} < 1e-3")

    # ---- [timing quad] ----
    secs = {}
    for method in ("quad", "dp5", "quad", "dp5"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inspiral.schwarz_ecc_flux_inspiral(
            *masses, batch[0], batch[1], t_years=T_YEARS, max_steps=MAX_STEPS,
            flux="multipole_rwz", flux_grid=grid, method=method)
        torch.cuda.synchronize()
        secs.setdefault(method, []).append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_fd("quad")
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    print(f"[timing quad] {BATCH}-walker rwz trajectory: quad "
          f"{' / '.join(f'{x * 1e3:.1f}' for x in secs['quad'])} ms, dp5 "
          f"{' / '.join(f'{x * 1e3:.1f}' for x in secs['dp5'])} ms (two runs each, alternating); "
          f"the whole quad batch (prologue + FD core) {whole * 1e3:.1f} ms, "
          f"{BATCH / whole:.2f} waveforms/s; host clock, synchronized; on {card}", flush=True)

    def run_quad():
        inspiral.schwarz_ecc_flux_inspiral(
            *masses, batch[0], batch[1], t_years=T_YEARS, max_steps=MAX_STEPS,
            flux="multipole_rwz", flux_grid=grid, method="quad")

    return dict(tables=tables[0], launches=launches, run_quad=run_quad,
                quad_ms=1e3 * sum(secs["quad"]) / len(secs["quad"]))


def drive_scan(env):
    """`cli/check_mode_by_mode.py`'s `run_check` on the card at the paper's
    size for one draw, with its checks; returns the full-grid FD call's
    tables and the scan's kernel launches."""
    torch, card = env["torch"], env["card"]
    fd_dense, summation_fd = env["fd_dense"], env["summation_fd"]
    from emri_frequencydomainwaveforms_tpu_torch.cli import check_mode_by_mode as scan

    args = scan.build_parser().parse_args(SCAN_ARGS.split())
    calls = []

    def keep(groups, *, r, nf):
        calls.append((groups, r, nf))
        return fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)

    fd_dense.fd_dense_accumulate.launches = 0
    with dense_function(summation_fd, keep):
        res = scan.run_check(args, write=False)
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    check(res["failed_points"] == [], f"[scan] failed points {res['failed_points']}")
    check(launches > 0 and launches == len(calls), f"[scan] fd_dense launches {launches}")
    full = max(calls, key=lambda c: c[2])
    check(full[2] == env["nf"] and full[0][0].pc.shape[0] == 1,
          f"[scan] the full-grid FD call (nf {full[2]}) went through the kernel")
    mism = {w: res["mismatch"][w][0] for w in scan.WINDOWS}
    values = [res[k][0] for k in ("SNR", "loglike", "timing_fd", "timing_fd_downsampled",
                                  "timing_td")] + list(mism.values())
    check(all(np.isfinite(v) for v in values), f"[scan] stored values finite: {values}")
    check(all(0.0 < v < 1.0 for v in mism.values()), f"[scan] mismatches in (0, 1): {mism}")
    m_c, mu, _, p0, e0 = res["list_injections"][0][:5]
    t_fd, t_ds, t_td = (res[k][0] for k in ("timing_fd", "timing_fd_downsampled", "timing_td"))
    print(f"[scan] run_check({SCAN_ARGS}; flux {args.flux}, amp {args.amp}, "
          f"{args.turnover_slots} turnover slots) on the card: M {m_c:.6e}, mu {mu:.6f}, "
          f"e0 {e0:.6f}, p0 {p0:.6f}; no failed point; fd_dense "
          f"launches {launches} (the full-grid call at nf {full[2]}, r {full[1]}); windowed FD/TD "
          f"mismatch " + ", ".join(f"{w} {v:.4e}" for w, v in mism.items())
          + f" (gate 2's bound for hann: 1e-4); SNR {res['SNR'][0]:.4f}; log L "
          f"{res['loglike'][0]:.6e}; t_fd {t_fd:.3f} s, t_fd_downsampled {t_ds:.3f} s, t_td "
          f"{t_td:.3f} s, speed-up t_td / t_fd {t_td / t_fd:.3f}; host clock; on {card}",
          flush=True)
    return dict(tables=full, launches=launches)


def drive_facades(env):
    """The reference-signature facades on the card against the CPU."""
    torch = env["torch"]
    from emri_frequencydomainwaveforms_tpu_torch.models import utility

    traj = env["inspiral"].EMRIInspiral(max_steps=256)(1e6, 10.0, 0.0, 12.0, 0.35, 1.0, T=0.1)
    full = env["inspiral"].schwarz_ecc_flux_inspiral(1e6, 10.0, 12.0, 0.35, t_years=0.1,
                                                     max_steps=256)
    n = int(full.n[0])
    check(traj[0].device == env["dev"] and all(
        torch.equal(a, getattr(full, k)[0, :n]) for a, k in zip(
            traj, ("t", "p", "e", "x", "Phi_phi", "Phi_theta", "Phi_r"))),
        "[facades] EMRIInspiral equals lane 0 of the trajectory, trimmed, on the card")
    worst = 0.0
    for a, p, e, x in ((0.0, 9.0, 0.3, 1.0), (0.6, 7.0, 0.2, 1.0), (0.5, 9.0, 0.3, 0.7)):
        on_card = [*utility.get_fundamental_frequencies(a, p, e, x),
                   utility.get_separatrix(a, e, x)]
        on_cpu = [*utility.get_fundamental_frequencies(a, p, e, x, device="cpu"),
                  utility.get_separatrix(a, e, x, device="cpu")]
        for u, v in zip(on_card, on_cpu):
            check(np.isfinite(u).all(), f"[facades] finite at {(a, p, e, x)}")
            worst = max(worst, float(np.max(np.abs(u - v) / np.abs(v))))
    check(worst <= 1e-12, f"[facades] card vs CPU {worst:.3e} <= 1e-12")
    print(f"[facades] EMRIInspiral = lane 0 of schwarz_ecc_flux_inspiral on the card ({n} live "
          f"knots); get_fundamental_frequencies and get_separatrix at a Schwarzschild, an "
          f"equatorial-Kerr and an inclined-Kerr point, card vs CPU: {worst:.3e} (<= 1e-12)",
          flush=True)


def amp_error(got, ref):
    """tests/test_rwz_calibration.py's interpolation metric: per point and
    mode, (|d re| + |d im|) / max(|re| + |im|, 1e-3 of the largest), over
    the dominant entries (above 0.1 of the largest) and over all of them."""
    mag = ref[0].abs() + ref[1].abs()
    err = ((got[0] - ref[0]).abs() + (got[1] - ref[1]).abs()) / mag.clamp_min(1e-3 * float(mag.max()))
    dominant = mag > 0.1 * float(mag.max())
    return float(err[dominant].max()), float(err.max())


def grid_float32_noise(values, ref, modes):
    """Two amplitude grids (nu, ne, M, 2) compared as
    tests/test_torch_backends.py compares the port's with the JAX
    package's: the largest per-point relative L2 over all modes, and over
    ``modes`` the largest |difference| / that point's largest |A|."""
    import torch

    d = (values - ref).pow(2).sum(-1).sqrt()
    a = ref.pow(2).sum(-1).sqrt()
    per_point = d.pow(2).sum(-1).sqrt() / a.pow(2).sum(-1).sqrt()
    idx = torch.as_tensor(np.asarray(modes), device=values.device)
    frozen = d[..., idx] / a[..., idx].amax(-1, keepdim=True)
    return float(per_point.max()), float(frozen.max())


def drive_backends(env, rwz):
    """The data-driven amplitude backends on the card, against
    `full_fidelity_amplitudes` at the rwz batch's own live knots."""
    torch, dev, card = env["torch"], env["dev"], env["card"]
    amplitude, table = env["amplitude"], env["table"]
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude_backends as back

    table_k, forced_idx = rwz["table_k"], rwz["forced_idx"]
    full = amplitude.full_fidelity_amplitudes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = back.build_amplitude_grid(table, source=full)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_cpu = back.build_amplitude_grid(table, source=full, device="cpu")
    check(grid.values.device == dev and tuple(grid.values.shape) == (64, 33, table.num_modes, 2),
          f"[backends] grid {tuple(grid.values.shape)} on {grid.values.device}")
    check(bool(torch.isfinite(grid.values).all()), "[backends] grid finite")
    grid_l2, frozen_err = grid_float32_noise(grid.values.cpu(), grid_cpu.values, forced_idx)
    check(grid_l2 <= GRID_L2_TOL and frozen_err <= GRID_FROZEN_TOL,
          f"[backends] grid card vs CPU: per-point rel L2 {grid_l2:.3e} <= {GRID_L2_TOL}, frozen "
          f"slots {frozen_err:.3e} <= {GRID_FROZEN_TOL} of each point's largest")

    # Interp2DAmplitude at the batch's live knots, on the 16 frozen slots
    traj = rwz["traj"]
    live = torch.arange(traj.p.shape[1], device=dev)[None, :] < traj.n[:, None]
    p, e = traj.p[live], traj.e[live]
    grid_k = grid._replace(values=grid.values[:, :, torch.as_tensor(forced_idx, device=dev)],
                           table=table_k)
    got = back.mode_amplitudes_interp2d(p, e, grid_k)
    ref = full(p, e, table_k)
    dom_err, all_err = amp_error(got, ref)
    facade = back.Interp2DAmplitude(grid_k)(p[:4].cpu().numpy(), e[:4].cpu().numpy(),
                                            specific_modes=[(2, 2, 0), (2, -2, 0)])
    conj_ok = np.allclose(facade[(2, -2, 0)], np.conj(facade[(2, 2, 0)]), rtol=1e-12, atol=0)
    check(conj_ok, "[backends] Interp2DAmplitude (l, -m, -n) = (-1)^l conj(A)")
    check(dom_err < 2e-3 and all_err < 5e-2,
          f"[backends] interp vs direct at the knots: dominant {dom_err:.3e} < 2e-3, "
          f"all {all_err:.3e} < 5e-2")

    # ROMAN: 300 Adam steps of 512 orbits against the full-fidelity source
    params0 = back.init_roman_network(table_k, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = back.fit_roman_network(params0, n_steps=ROMAN_STEPS, batch=512, seed=2, source=full)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(all(w.device == dev and w.dtype == torch.float64 for w in params.weights),
          "[backends] the network's weights float64 on the card")
    untrained = params0._replace(scale=params.scale)
    ps = torch.tensor([9.0, 11.0], dtype=torch.float64, device=dev)
    es = torch.tensor([0.2, 0.4], dtype=torch.float64, device=dev)
    direct = full(ps, es, table_k)

    def max_err(pr):
        out = back.roman_forward(pr, ps, es)
        return max(float((a - b).abs().max()) for a, b in zip(out, direct))

    def probe_loss(pr):
        rng = np.random.default_rng(11)
        u = rng.uniform(np.log(0.55), np.log(12.0), 512)
        eb = torch.as_tensor(rng.uniform(1e-4, 0.7, 512), device=dev)
        pb = torch.as_tensor(np.exp(u) - 0.5 + 6.0, device=dev) + 2.0 * eb
        tr, ti = full(pb, eb, table_k)
        mre, mim = back.roman_forward(pr, pb, eb)
        n = table_k.num_modes
        return float(torch.mean(((mre - tr) / pr.scale[:n]) ** 2 + ((mim - ti) / pr.scale[n:]) ** 2))

    err0, err1 = max_err(untrained), max_err(params)
    loss0, loss1 = probe_loss(untrained), probe_loss(params)
    check(err1 < 0.25 * err0, f"[backends] trained error {err1:.3e} < 0.25 x untrained {err0:.3e}")
    # roman_forward on the card against the CPU, same params
    cpu_params = back.RomanParams(tuple(w.cpu() for w in params.weights),
                                  tuple(b.cpu() for b in params.biases), table_k, params.scale.cpu())
    pk, ek = p[:4096], e[:4096]
    on_card = back.roman_forward(params, pk, ek)
    on_cpu = back.roman_forward(cpu_params, pk.cpu(), ek.cpu())
    fwd_err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(on_card, on_cpu))
    check(fwd_err <= 1e-12, f"[backends] roman_forward card vs CPU {fwd_err:.3e} <= 1e-12")
    module = back.RomanAmplitude(params)
    check(all(isinstance(w, torch.nn.Parameter) and w.dtype == torch.float64
              for w in module.parameters()), "[backends] RomanAmplitude holds float64 Parameters")
    print(f"[backends] build_amplitude_grid(default_mode_table(30), full_fidelity_amplitudes) "
          f"(64, 33, {table.num_modes}, 2) on the card in {grid_s:.2f} s, card vs CPU: per-point "
          f"rel L2 over the modes {grid_l2:.3e} (<= {GRID_L2_TOL}), the {len(forced_idx)} frozen "
          f"slots {frozen_err:.3e} of each point's largest (<= {GRID_FROZEN_TOL}); Interp2D at the rwz batch's {p.numel()} live "
          f"knots on the {table_k.num_modes} frozen slots vs full_fidelity_amplitudes: dominant "
          f"{dom_err:.4e} (< 2e-3), all {all_err:.4e} (< 5e-2), conjugate rule exact; "
          f"fit_roman_network {ROMAN_STEPS} steps x 512 on the card in {fit_s:.2f} s: probe "
          f"loss {loss0:.4e} untrained -> {loss1:.4e} trained, max error at two orbits "
          f"{err0:.4e} -> {err1:.4e} (< 0.25x); roman_forward card vs CPU {fwd_err:.3e} "
          f"(<= 1e-12); on {card}", flush=True)


class _Captured(Exception):
    """Stops the FD core once its kernel inputs are taken."""


def drive_pallas_names(env, rwz):
    """The reference's Pallas-named entry points on the rwz batch at full
    width, against `fd_mode_sum_uniform` on the same inputs and the same
    windows (the wrapper's window starts, rounded down to 128 runs); then
    every lane of the wrapper and of the production windows against
    whole-grid windows. Returns the wrapper's kernel tables and launches
    (B = 128 and B = 1)."""
    torch, card = env["torch"], env["card"]
    wf, fd_dense, summation_fd = env["wf"], env["fd_dense"], env["summation_fd"]
    nf, f0u, dfu = env["nf"], env["f0u"], env["dfu"]
    gen, pro, table_k = rwz["gen"], rwz["pro"], rwz["table_k"]
    offsets = gen.band_offsets
    # the wrapper's own window starts (summation_fd.py:1378-1380 of the reference)
    g_total = -(-nf // BINS_PER_RUN)
    rounded = (torch.div(offsets, 128, rounding_mode="floor") * 128).clamp(0, g_total)
    seen = []

    def grab(inp, *args, **kwargs):
        seen.append(inp)
        raise _Captured

    # the batch's FDKernelInputs, as the FD core hands them to the banded kernel
    with patched(wf, "fd_mode_sum_uniform", grab):
        try:
            wf.fd_waveform_core(pro, table_k, nf, channels=True, uniform=(f0u, dfu),
                                band_offsets=offsets, bins_per_run=BINS_PER_RUN)
        except _Captured:
            pass
    inp = seen[0]
    del seen
    check(inp.t_knots.shape[0] == BATCH, f"[pallas-names] inputs for B={inp.t_knots.shape[0]}")

    def scaled_err(a, b):
        """Worst channel's max |a - b| / max |b|, and per lane (B,)."""
        lanes = torch.stack([(x - y).abs().amax(-1) / y.abs().amax(-1) for x, y in zip(a, b)])
        return float(lanes.max()), lanes.amax(0)

    def run(inp_, batched):
        tables = []
        kw = dict(bins_per_run=BINS_PER_RUN, band_runs=PALLAS_RUNS)
        fd_dense.fd_dense_accumulate.launches = 0
        with dense_function(summation_fd, capturing(fd_dense.fd_dense_accumulate, tables)):
            fn = (summation_fd.fd_mode_sum_uniform_pallas_batched if batched
                  else summation_fd.fd_mode_sum_uniform_pallas)
            got = fn(inp_, f0u, dfu, nf, band_offsets=offsets, **kw)
        torch.cuda.synchronize()
        launches = fd_dense.fd_dense_accumulate.launches
        check(all(o.shape == (inp_.t_knots.shape[0], nf) and o.dtype == torch.float64
                  and bool(torch.isfinite(o).all()) for o in got), "[pallas-names] outputs")
        check(tables[0][0][0].pc.shape[2] == PALLAS_RUNS and
              bool((tables[0][0][0].g0 == rounded).all()),
              "[pallas-names] windows of 384 runs from the rounded-down starts")
        ref = summation_fd.fd_mode_sum_uniform(inp_, f0u, dfu, nf, band_offsets=rounded, **kw)
        return got, scaled_err(got, ref)[0], launches, tables[0]

    got, err, launches, tables = run(inp, True)
    check(launches > 0, "[pallas-names] the batched wrapper launched the fd_dense kernel")
    check(err < 1e-4, f"[pallas-names] B=128 wrapper vs fd_mode_sum_uniform {err:.4e} < 1e-4")
    # what the windows drop, lane by lane: the wrapper's, and the production
    # 256-run windows at the batch's own offsets, against whole-grid windows
    # (32 lanes at a time: whole-grid level-1 tables are large)
    lanes_w, lanes_p = [], []
    for lo in range(0, BATCH, 32):
        part = summation_fd.FDKernelInputs(*(x[lo:lo + 32] for x in inp))
        full = summation_fd.fd_mode_sum_uniform(part, f0u, dfu, nf, bins_per_run=BINS_PER_RUN)
        lanes_w.append(scaled_err([o[lo:lo + 32] for o in got], full)[1])
        prod = summation_fd.fd_mode_sum_uniform(part, f0u, dfu, nf, bins_per_run=BINS_PER_RUN,
                                                band_runs=BAND_RUNS, band_offsets=offsets)
        lanes_p.append(scaled_err(prod, full)[1])
        del full, prod
    del got
    lanes_w, lanes_p = torch.cat(lanes_w), torch.cat(lanes_p)
    trunc_w, trunc_p = float(lanes_w.max()), float(lanes_p.max())
    worst_p = int(torch.argmax(lanes_p))
    lane0 = summation_fd.FDKernelInputs(*(x[:1] for x in inp))
    del inp
    _, err_1, launches_1, tables_1 = run(lane0, False)
    check(launches_1 > 0, "[pallas-names] the one-walker wrapper launched the fd_dense kernel")
    check(err_1 < 1e-4, f"[pallas-names] B=1 wrapper vs fd_mode_sum_uniform {err_1:.4e} < 1e-4")
    print(f"[pallas-names] fd_mode_sum_uniform_pallas_batched on the rwz batch's FDKernelInputs "
          f"(B={BATCH}, nf={nf}, r={BINS_PER_RUN}, band_runs {PALLAS_RUNS}, the batch's "
          f"band_offsets rounded down to 128 runs, one slot group) vs fd_mode_sum_uniform on "
          f"the same windows: max/scale {err:.4e} (< 1e-4, tests/test_waveform.py:163); "
          f"fd_dense launches {launches}; one-walker form on lane 0: {err_1:.4e}, launches "
          f"{launches_1}. Against whole-grid windows, lane by lane: the wrapper's windows worst "
          f"{trunc_w:.4e}; the production {BAND_RUNS}-run windows at the unrounded offsets "
          f"worst {trunc_p:.4e} (lane {worst_p}; {int((lanes_p > 1e-4).sum())} lanes past "
          f"1e-4, lane 0 {float(lanes_p[0]):.4e}); on {card}", flush=True)
    return dict(tables=tables, launches=launches, tables_1=tables_1, launches_1=launches_1)


def drive_fisher(env, pe_run):
    """`lisa.diagnostic`'s Fisher set on the PE likelihood's template at the
    injection, on the card and, for the same source, on the CPU."""
    torch, card = env["torch"], env["card"]
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
    from emri_frequencydomainwaveforms_tpu_torch.lisa import diagnostic

    args, out = pe_run["args"], pe_run["out"]
    like, truth = out["likelihood"], out["truth"]
    ip = dict(f_arr=out["f_arr"], PSD=out["noise_fn"])
    grid = out["flux_grid"]

    def waveform(template):
        """The template at one point of the FISHER_PARAMS (the rest at the
        truth), as complex channels on the template's device. Its memo holds
        the points `evaluate` computed in one batch (the template's batched
        contract: each walker's value does not depend on the batch)."""
        memo = {}

        def evaluate(points):
            x = np.repeat(truth[None], len(points), axis=0)
            x[:, list(FISHER_PARAMS)] = points
            chans = template(like.transform.both_transforms(torch.as_tensor(x)))
            for k, q in enumerate(points):
                memo[q.tobytes()] = [re[k].double() + 1j * im[k].double() for re, im in chans]

        def wf(q):
            q = np.asarray(q, dtype=np.float64)
            if q.tobytes() not in memo:
                evaluate(q[None])
            return memo[q.tobytes()]

        wf.evaluate = evaluate
        return wf

    def stencil(q0, eps):
        """The centre and the points `dh_dlambda` asks for, built as it
        builds them (so the memo's keys match bit for bit)."""
        pts = [q0]
        for i, e in enumerate(eps):
            for delta in (2 * e, e, -e, -2 * e):
                p = q0.copy()
                p[i] += delta
                pts.append(p)
        return np.stack(pts)

    card_t = emri_pe.fd_template(args, out["table"], out["forced_idx"], out["f_arr"],
                                 flux_grid=grid, device=env["dev"])
    grid_cpu = None if grid is None else grid._replace(values=grid.values.cpu())
    cpu_t = emri_pe.fd_template(args, out["table"], out["forced_idx"], out["f_arr"],
                                flux_grid=grid_cpu, device="cpu")
    wf_card, wf_cpu = waveform(card_t), waveform(cpu_t)
    q0 = truth[list(FISHER_PARAMS)].copy()
    # steps that move the waveform by FISHER_STEP of its norm (the stencil's
    # truncation is then ~(2 x 0.1)^4 / 30 ~ 5e-5 relative), from one probe
    # step per parameter, all in one batch
    probes = q0[None] + np.diag(FISHER_PROBE)
    wf_card.evaluate(np.concatenate([q0[None], probes]))
    h0 = [h.cpu().numpy() for h in wf_card(q0)]
    norm0 = np.sqrt(sum(np.sum(np.abs(h) ** 2) for h in h0))
    eps = []
    for i, probe in enumerate(FISHER_PROBE):
        moved = np.sqrt(sum(np.sum(np.abs(a.cpu().numpy() - b) ** 2)
                            for a, b in zip(wf_card(probes[i]), h0)))
        check(moved > 0, f"[fisher] parameter {FISHER_PARAMS[i]} moves the waveform")
        eps.append(probe * FISHER_STEP * norm0 / moved)
    eps = np.array(eps)
    points = stencil(q0, eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf_card.evaluate(points)
    gamma = diagnostic.fisher(wf_card, q0, eps, **ip)
    fisher_s = time.perf_counter() - t0
    try:
        import mpmath  # noqa: F401  (torch's sympy brings it)
        precise = True
    except ImportError:
        precise = False
    # the same stencil points again, from the memo: no new template call
    cov = diagnostic.covariance(wf_card, q0, eps, precision=precise, **ip)
    w, _ = diagnostic.get_eigens(gamma)
    d = np.sqrt(np.diag(gamma))
    ident = np.abs((cov * d[:, None] * d[None, :]) @ (gamma / d[:, None] / d[None, :])
                   - np.eye(len(q0))).max()
    check(bool(np.isfinite(gamma).all() and np.isfinite(cov).all()), "[fisher] finite")
    check(np.array_equal(gamma, gamma.T), "[fisher] symmetric")
    check(bool((w > 0).all()), f"[fisher] eigenvalues {w} positive")
    check(ident <= 1e-6, f"[fisher] (D cov D)(D^-1 Gamma D^-1) - I max {ident:.3e} <= 1e-6")
    t0 = time.perf_counter()
    wf_cpu.evaluate(points)
    gamma_cpu = diagnostic.fisher(wf_cpu, q0, eps, **ip)
    cpu_s = time.perf_counter() - t0
    h_cpu = [h.numpy() for h in wf_cpu(q0)]
    wave_err = np.sqrt(sum(np.sum(np.abs(a - b) ** 2) for a, b in zip(h0, h_cpu))) / norm0
    diff = np.abs(gamma - gamma_cpu) / np.outer(d, d)
    check(diff.max() <= FISHER_TOL, f"[fisher] card vs CPU {diff.max():.3e} <= {FISHER_TOL}")
    names = ["lnM", "ln(mu/M)", "p0", "e0", "Phi_phi0", "Phi_r0"]
    sigma = np.sqrt(np.diag(cov))
    print(f"[fisher] fisher over ({', '.join(names[i] for i in FISHER_PARAMS)}) at the [pe] "
          f"injection, the PE template ({args.flux}, {args.Tobs} yr, {len(out['f_arr'])} bins), eps "
          f"{np.array2string(eps, precision=3)} (each moving the waveform by {FISHER_STEP} of "
          f"its norm): the {len(points)} stencil points as one template batch, fisher on the card "
          f"in {fisher_s:.2f} s, on the CPU in {cpu_s:.2f} s; covariance({'precision=True, mpmath' if precise else 'precision=False: no mpmath'}) "
          f"sigma {np.array2string(sigma, precision=4)}; eigenvalues "
          f"{np.array2string(w, precision=4)} (all > 0); symmetric; scaled cov @ Gamma - I "
          f"{ident:.3e} (<= 1e-6); card vs CPU: template at the injection rel L2 {wave_err:.3e}, "
          f"Fisher max |dGamma_ij| / sqrt(Gamma_ii Gamma_jj) {diff.max():.3e} (<= {FISHER_TOL}); "
          f"on {card}", flush=True)
    # the covariance for [moves], the template at the injection for [tdi]
    return dict(cov=cov, h0=wf_card(q0))


def drive_relbin(env):
    """`lisa.relbin` on tests/test_relbin.py's chirp, the per-call core on
    the card for a 64-walker batch, against the dense log L on the card."""
    torch, dev, card = env["torch"], env["dev"], env["card"]
    from emri_frequencydomainwaveforms_tpu_torch.lisa.relbin import RelativeBinningLikelihood

    f = np.linspace(1e-3, 2e-2, 40000)
    psd = 1e-40 * (1.0 + (3e-3 / f) ** 4 + (f / 1e-2) ** 2)
    f_t, psd_t = (torch.as_tensor(x, device=dev) for x in (f, psd))

    def chirp(params, ff):
        # tests/test_relbin.py's PN-like toy: (n, 4) -> (re, im) of (n, len(ff))
        a, t0, phi0, eta = (params[..., i:i + 1] for i in range(4))
        psi = 2 * np.pi * ff * t0 + phi0 + eta * (ff / 1e-2) ** (-5.0 / 3.0)
        amp = a * (ff / 1e-2) ** (-7.0 / 6.0) * 1e-19
        return amp * torch.cos(psi), amp * torch.sin(psi)

    truth = np.array([1.0, 5e3, 0.8, 2.0])
    fid = truth * (1.0 + 1e-4)

    def dense(params):
        re, im = chirp(torch.as_tensor(params, device=dev), f_t)
        data = chirp(torch.as_tensor(truth[None], device=dev), f_t)
        res = (data[0] - re) ** 2 + (data[1] - im) ** 2
        return -0.5 * torch.sum(4.0 * (f[1] - f[0]) * res / psd_t, dim=-1)

    def complex_of(params):
        re, im = chirp(torch.as_tensor(params[None], device=dev), f_t)
        return (re[0] + 1j * im[0]).cpu().numpy()

    like = None

    def template_fn(params):
        return [chirp(torch.as_tensor(params, device=dev), like.f_edges_t)]

    like = RelativeBinningLikelihood(template_fn, f, [complex_of(truth)], [complex_of(fid)], psd,
                                     max_bins=512)
    rng = np.random.default_rng(3)
    scales = np.array([1e-3, 3e-2, 3e-3, 1e-4]) * np.abs(truth)
    walkers = truth + rng.standard_normal((RELBIN_WALKERS, 4)) * scales
    rb = like(torch.as_tensor(walkers, device=dev))
    full = dense(walkers)
    check(rb.shape == (RELBIN_WALKERS,) and rb.device == dev and bool(torch.isfinite(rb).all()),
          "[relbin] the 64-walker call is finite, on the card")
    err = (rb - full).abs().cpu().numpy()
    spread = float(full[:12].abs().max())
    at_fid = abs(float(like.logl(torch.as_tensor(fid, device=dev)) - dense(fid[None])[0]))
    check(at_fid < 1e-6 * max(abs(float(dense(fid[None])[0])), 1.0), f"[relbin] at the fiducial {at_fid:.3e}")
    check(spread > 1.0 and err[:12].max() < 0.02 * spread,
          f"[relbin] 12 draws: max error {err[:12].max():.3e} < 0.02 x spread {spread:.3e}")
    w_t = torch.as_tensor(walkers, device=dev)
    rb_ms = time_ms(lambda: like(w_t), 20, torch)
    dense_ms = time_ms(lambda: dense(walkers), 20, torch)
    print(f"[relbin] RelativeBinningLikelihood on tests/test_relbin.py's chirp (40000 frequencies, "
          f"{like.nbins} bins): exact at the fiducial to {at_fid:.3e}; 12 posterior-scale draws "
          f"max |rb - dense| {err[:12].max():.4e} < 0.02 x spread {spread:.4e} "
          f"({RELBIN_WALKERS} walkers: max {err.max():.4e}); one {RELBIN_WALKERS}-walker call "
          f"{rb_ms:.4f} ms, the dense log L on the card {dense_ms:.4f} ms (CUDA events, "
          f"template included); on {card}", flush=True)


def drive_diagnostics(env, pe_run):
    """The sampler diagnostics on the [pe] run's backend and sampler."""
    from emri_frequencydomainwaveforms_tpu_torch.inference import stopping

    out = pe_run["out"]
    backend, sampler = out["backend"], out["sampler"]
    tau = backend.get_autocorr_time()["emri"]
    logz, dlogz = backend.get_evidence_estimate()
    indep = sampler.walkers_independent()
    state = backend.get_last_sample()
    stop = stopping.AutoCorrelationStop()(0, state, sampler)
    a0 = sampler.move.a
    stopping.AdjustStretchProposalScale()(0, state, sampler)
    a1 = sampler.move.a
    check(tau.shape == (6,) and bool(np.isfinite(tau).all()), f"[diagnostics] tau {tau}")
    check(np.isfinite(logz) and np.isfinite(dlogz), f"[diagnostics] log Z {logz}, {dlogz}")
    check(isinstance(indep, bool) and isinstance(stop, bool), "[diagnostics] bools")
    check(np.isfinite(a1) and 1.1 <= a1 <= 10.0, f"[diagnostics] stretch a {a1}")
    print(f"[diagnostics] on the [pe] chain ({backend.iteration} steps, {backend.ntemps} "
          f"temperatures): get_autocorr_time {np.array2string(tau, precision=4)}; "
          f"get_evidence_estimate log Z {logz:.6e} +- {dlogz:.3e}; walkers_independent {indep}; "
          f"AutoCorrelationStop -> {stop}; AdjustStretchProposalScale a {a0} -> {a1:.6f} "
          f"(acceptance {float(np.mean(sampler.acceptance_fraction)):.3f})", flush=True)


def drive_moves(env, pe_run, fisher):
    """The move library and the move schedule on the [pe] likelihood at full
    width, from [pe]'s last state cut to MOVES_TEMPS x MOVES_WALKERS (its
    stored log L and log prior, so the start costs no call): step 1 one
    `CombineMove` of eight moves, steps 2-3 `DIMEMove` alone (its state
    threaded through ``State.move_info``), step 4 the weighted schedule of
    DIME and a Gaussian. Counts the dense-pass launches and keeps the tables
    of the phase's first batched call."""
    torch, card = env["torch"], env["card"]
    fd_dense, summation_fd = env["fd_dense"], env["summation_fd"]
    from emri_frequencydomainwaveforms_tpu_torch.inference import EnsembleSampler, make_state
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.inference.moves import (
        CombineMove, DelayedRejectionMove, DIMEMove, DIMEState, DistributionGenerate,
        GaussianMove, GroupStretchMove, MTDistGenMove, MultiSourceFisherProposal)

    out = pe_run["out"]
    like, pe_sampler = out["likelihood"], out["sampler"]
    prior, per = pe_sampler._prior, pe_sampler.periodic_vec
    last = out["backend"].get_last_sample()
    nt, nw = MOVES_TEMPS, MOVES_WALKERS
    start = make_state(last.branches["emri"].coords[:nt, :nw], log_like=last.log_like[:nt, :nw],
                       log_prior=last.log_prior[:nt, :nw], betas=last.betas[:nt],
                       random_state=MOVES_SEED, name="emri")
    friends = last.branches["emri"].coords[:, :, 0, :].reshape(-1, 6)
    # [fisher]'s Cramer-Rao block, and (MOVES_WIDTH x the prior's width)^2 on
    # the diagonal of the other parameters
    cov = np.zeros((6, 6))
    block = np.array(FISHER_PARAMS)
    cov[np.ix_(block, block)] = 0.5 * (fisher["cov"] + fisher["cov"].T)
    for i in sorted(set(range(6)) - set(FISHER_PARAMS)):
        d = prior.priors_in[i]
        cov[i, i] = (MOVES_WIDTH * (d.max_val - d.min_val)) ** 2

    rows, seen, times, acc = [], {}, {}, {}

    def logl(x):
        rows.append(x.shape[0])
        return like(x)

    def keep_first(groups, *, r, nf):
        key = "tables_1" if groups[0].pc.shape[0] == 1 else "tables"
        seen.setdefault(key, (groups, r, nf))
        seen[key + "_calls"] = seen.get(key + "_calls", 0) + 1
        return fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)

    def timed(name, move):
        step = move.step

        def run(coords, *a):
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), len(rows)
            res = step(coords, *a)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0, len(rows) - n0, sum(rows[n0:]))
            acc[name] = float(res[3].sum()) / (nt * nw)
            return res

        move.step = run
        return move

    def sampler(moves):
        return EnsembleSampler(
            nw, [6], logl, {"emri": prior}, moves=moves, backend=Backend(), branch_names=["emri"],
            tempering_kwargs={"ntemps": nt, "betas": start.betas.numpy()}, seed=MOVES_SEED,
            periodic={"emri": {i: float(p) for i, p in enumerate(per) if p > 0}})

    step1 = [("Gaussian(cov)", GaussianMove(cov, periodic=per)),
             ("MultiSourceFisherProposal(cov)", MultiSourceFisherProposal(cov, periodic=per)),
             ("Gaussian DE", GaussianMove(cov, mode="DE", periodic=per)),
             ("Gaussian AM", GaussianMove(cov, mode="AM", periodic=per)),
             ("DistributionGenerate", DistributionGenerate(prior)),
             ("DelayedRejection", DelayedRejectionMove(np.sqrt(np.diag(cov)), periodic=per)),
             ("MTDistGen(num_try=2)", MTDistGenMove(prior, num_try=2)),
             ("GroupStretch(128 friends)", GroupStretchMove(friends=friends, periodic=per))]
    fd_dense.fd_dense_accumulate.launches = 0
    samplers = []
    with dense_function(summation_fd, keep_first):
        s1 = sampler(CombineMove([timed(n, m) for n, m in step1]))
        samplers.append(s1)
        state = s1.run_mcmc(start, 1)
        t0, n0 = time.perf_counter(), len(rows)
        s2 = sampler(DIMEMove())
        samplers.append(s2)
        state = s2.run_mcmc(state._replace(move_info=None), 2)
        torch.cuda.synchronize()
        times["DIME x 2 steps"] = (time.perf_counter() - t0, len(rows) - n0, sum(rows[n0:]))
        dime = state.move_info[0]
        s3 = sampler([(DIMEMove(), 0.5), (GaussianMove(cov, periodic=per), 0.5)])
        samplers.append(s3)
        picked, select = [], s3._select_move
        s3._select_move = lambda gen: picked.append(select(gen)) or picked[-1]
        t0, n0 = time.perf_counter(), len(rows)
        state = s3.run_mcmc(state._replace(move_info=(dime, None)), 1)
        torch.cuda.synchronize()
        times["schedule step"] = (time.perf_counter() - t0, len(rows) - n0, sum(rows[n0:]))
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    n_1, n_b = seen.get("tables_1_calls", 0), seen.get("tables_calls", 0)
    check(launches > 0 and launches == n_1 + n_b and n_b > 0,
          f"[moves] the moves launched the fd_dense kernel ({launches} = {n_1} + {n_b})")

    # the stored chains, the acceptance, the carried DIME state
    for s in samplers:
        ll = s.get_log_like()
        check(bool(np.isfinite(ll).all() and (ll > -1e300).all()),
              f"[moves] every stored log L finite ({ll.min():.4e})")
    fracs = list(acc.values()) + [float(np.mean(s.acceptance_fraction)) for s in samplers[1:]]
    check(all(0.0 <= a <= 1.0 for a in fracs), f"[moves] acceptance {fracs} in [0, 1]")
    check(isinstance(dime, DIMEState) and bool(torch.isfinite(dime.mean).all())
          and bool(torch.isfinite(dime.cov).all()) and bool(torch.isfinite(dime.cumlweight)),
          f"[moves] move_info after steps 2-3 holds a finite DIMEState ({dime.cumlweight})")
    # the final walkers' stored log L against a fresh evaluation on the card
    coords = state.branches["emri"].coords[:, :, 0, :].reshape(-1, 6)
    fresh = like(coords).double().cpu().numpy().reshape(nt, nw)
    stored = state.log_like.numpy()
    rel = float(np.max(np.abs(fresh - stored) / np.abs(stored)))
    check(rel <= MOVES_LL_TOL, f"[moves] stored vs fresh log L rel {rel:.3e} <= {MOVES_LL_TOL}")
    per_move = "; ".join(f"{n} {t:.2f} s ({c} calls, {r} walkers, acceptance {acc[n]:.3f})"
                         if n in acc else f"{n} {t:.2f} s ({c} calls, {r} walkers)"
                         for n, (t, c, r) in times.items())
    print(f"[moves] from [pe]'s last state cut to {nt} temperatures x {nw} walkers ({PE_ARGS}): "
          f"step 1 CombineMove of {len(step1)} moves, steps 2-3 DIMEMove, step 4 the schedule "
          f"[(DIMEMove, 0.5), (Gaussian(cov), 0.5)] drew move {picked[0]}; {per_move}; "
          f"{len(rows)} likelihood calls ({sum(rows)} walkers), fd_dense launches {launches} "
          f"({n_1} at B = 1, {n_b} batched); every stored log L finite, acceptance in [0, 1], "
          f"DIMEState cumlweight {float(dime.cumlweight):.6e} (finite); final stored vs fresh "
          f"log L max rel {rel:.3e} (<= {MOVES_LL_TOL}); host clock, synchronized; on {card}",
          flush=True)
    return dict(tables=seen["tables"], launches=n_b, cov=cov)


def drive_rj(env, pe_run, moves):
    """The multi-branch / reversible-jump sampler on the [pe] template at
    full width: one "emri" branch of up to 2 sources (at least 1) under a
    `GlobalLikelihood` that sums each walker's sources (the walker index is
    the group), [pe]'s injection and prior, the ensemble cut to RJ_TEMPS x
    RJ_WALKERS. Leaf 0 comes from [pe]'s last state; walkers 4-7 also hold a
    second source drawn from the prior. Step 1: `TreeStretchMove`, the
    prior-draw `DistributionGenerateRJ` (``rj_moves=True``) and the tree
    swaps; step 2: [moves]' `GaussianMove(cov)` lifted to a
    `TreeGaussianMove`, and `MTDistGenMoveRJ(num_try=2)`. Counts the
    dense-pass launches and keeps the tables of the phase's first batched
    call."""
    torch, card = env["torch"], env["card"]
    fd_dense, summation_fd = env["fd_dense"], env["summation_fd"]
    from emri_frequencydomainwaveforms_tpu_torch.inference import EnsembleSampler, make_state
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.inference.moves import (
        GaussianMove, MTDistGenMoveRJ, TreeStretchMove)
    from emri_frequencydomainwaveforms_tpu_torch.lisa import GlobalLikelihood

    out, args = pe_run["out"], pe_run["args"]
    like, prior = out["likelihood"], out["sampler"]._prior
    last = out["backend"].get_last_sample()
    nt, nw = RJ_TEMPS, RJ_WALKERS
    glike = GlobalLikelihood(like.template_model, 2, f_arr=out["f_arr"],
                             parameter_transforms=like.transform, subset=args.subset)
    glike.inject_signal(out["data"], noise_fn=out["noise_fn"])

    rows, seen, times, acc, computed = [], {}, {}, {}, {}

    def sources(c, i):
        """The key of one walker's active sources (2, 6) / (2,)."""
        return c[i].numpy().tobytes()

    def tree_ll(coords, inds):
        """(T', W', 2, 6) sources and their (T', W', 2) mask -> (T', W')
        log L: the active sources as rows, one GlobalLikelihood call. Each
        walker's value is kept under its sources."""
        shape = inds.shape[:2]
        c, i = coords.reshape(-1, 2, 6), inds.reshape(-1, 2)
        walker, leaf = torch.nonzero(i, as_tuple=True)
        check(torch.unique(walker).numel() == i.shape[0], "[rj] every evaluated walker holds a source")
        params = c[walker, leaf]
        rows.append(params.shape[0])
        ll = glike.get_ll(params, groups=walker).double().cpu()
        for k in range(i.shape[0]):
            computed.setdefault(sources(c[k], i[k]), []).append(float(ll[k]))
        return ll.reshape(shape)

    def keep_first(groups, *, r, nf):
        key = "tables_1" if groups[0].pc.shape[0] == 1 else "tables"
        seen.setdefault(key, (groups, r, nf))
        seen[key + "_calls"] = seen.get(key + "_calls", 0) + 1
        return fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)

    def timed(name, obj, attr):
        fn = getattr(obj, attr)

        def run(*a):
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), len(rows)
            res = fn(*a)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0, len(rows) - n0, sum(rows[n0:]))
            acc[name] = float(res[4].sum()) / (nt * nw)
            return res

        setattr(obj, attr, run)

    def sampler(moves_, rj_moves):
        return EnsembleSampler(
            nw, {"emri": 6}, tree_ll, {"emri": prior}, moves=moves_, rj_moves=rj_moves,
            nleaves_max={"emri": 2}, nleaves_min={"emri": 1}, backend=Backend(),
            branch_names=["emri"], tempering_kwargs={"ntemps": nt, "betas": last.betas[:nt].numpy()},
            seed=RJ_SEED)

    # leaf 0 from [pe]'s last state; a prior draw as leaf 1 of walkers 4-7,
    # the truth as the placeholder of the inactive ones
    coords = np.zeros((nt, nw, 2, 6))
    coords[:, :, 0] = last.branches["emri"].coords[:nt, :nw, 0].numpy()
    coords[:, :, 1] = out["truth"]
    coords[:, nw // 2:, 1] = prior.rvs(size=(nt, nw - nw // 2), random_state=RJ_SEED)
    inds = np.zeros((nt, nw, 2), dtype=bool)
    inds[:, :, 0] = True
    inds[:, nw // 2:, 1] = True
    start = make_state({"emri": coords}, inds={"emri": inds}, betas=last.betas[:nt],
                       random_state=RJ_SEED)

    fd_dense.fd_dense_accumulate.launches = 0
    samplers = []
    with dense_function(summation_fd, keep_first):
        s1 = sampler(TreeStretchMove(), True)
        samplers.append(s1)
        timed("TreeStretch", s1.move, "propose")
        timed("DistributionGenerateRJ", s1.rj_moves[0], "propose_tree")
        # the start: log L 0, so one call on every walker
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = s1._coerce_state(start)
        torch.cuda.synchronize()
        times["start"] = (time.perf_counter() - t0, len(rows), sum(rows))
        start_ll = state.log_like.clone()
        state = s1.run_mcmc(state, 1)
        s2 = sampler(GaussianMove(moves["cov"]),
                     [MTDistGenMoveRJ(prior, num_try=2, nleaves_min=1, nleaves_max=2)])
        samplers.append(s2)
        timed("TreeGaussian(cov)", s2.move, "propose")
        timed("MTDistGenRJ(num_try=2)", s2.rj_moves[0], "propose_tree")
        state = s2.run_mcmc(state, 1)
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    n_1, n_b = seen.get("tables_1_calls", 0), seen.get("tables_calls", 0)
    check(launches > 0 and launches == n_1 + n_b and n_b > 0,
          f"[rj] the tree sampler launched the fd_dense kernel ({launches} = {n_1} + {n_b})")
    check(type(s1.move).__name__ == "TreeStretchMove"
          and type(s2.move).__name__ == "TreeGaussianMove"
          and type(s1.rj_moves[0]).__name__ == "DistributionGenerateRJ",
          f"[rj] move types {type(s1.move).__name__}, {type(s2.move).__name__}, "
          f"{type(s1.rj_moves[0]).__name__}")

    # the start's one-source walkers: against [pe]'s stored log L, and
    # against the PE Likelihood on the same rows in the same batch
    one = slice(0, nw // 2)
    stored_pe = last.log_like[:nt, :nw].numpy()[:, one]
    rel_pe = float(np.max(np.abs(start_ll.numpy()[:, one] - stored_pe) / np.abs(stored_pe)))
    # the start call's rows, in its order (walker-major, leaf-minor)
    per_row = like(torch.from_numpy(coords[inds])).double().cpu().numpy()
    first_rows = np.concatenate([[0], np.cumsum(inds.reshape(-1, 2).sum(-1))[:-1]])
    same = per_row[first_rows].reshape(nt, nw)[:, one]
    rel_same = float(np.max(np.abs(start_ll.numpy()[:, one] - same) / np.abs(same)))
    check(rel_same <= RJ_SAME_BATCH_TOL,
          f"[rj] GlobalLikelihood vs Likelihood, same rows and batch, rel {rel_same:.3e} "
          f"<= {RJ_SAME_BATCH_TOL}")

    # the stored chains: finite log L, 1 or 2 sources, acceptances in [0, 1]
    fracs = dict(acc)
    for k, s in enumerate(samplers, 1):
        ll = s.get_log_like()
        check(bool(np.isfinite(ll).all() and (ll > -1e300).all()),
              f"[rj] step {k}: every stored log L finite ({ll.min():.4e})")
        nl = s.get_nleaves()["emri"]
        check(bool(((nl >= 1) & (nl <= 2)).all()),
              f"[rj] step {k}: every stored walker holds 1 or 2 sources ({nl.min()}-{nl.max()})")
        fracs[f"step {k} acceptance"] = float(np.mean(s.acceptance_fraction))
        fracs[f"step {k} rj acceptance"] = float(np.mean(s.backend.rj_acceptance_fraction))
    check(all(0.0 <= a <= 1.0 for a in fracs.values()), f"[rj] acceptances {fracs} in [0, 1]")
    # the accept and swap bookkeeping: each final walker's stored log L is
    # the value some call of the phase computed for exactly its sources;
    # then a fresh evaluation on the card (another batch)
    final_c = state.branches["emri"].coords.reshape(-1, 2, 6)
    final_inds = state.branches["emri"].inds
    stored = state.log_like.numpy()
    owned = [float(v) in computed.get(sources(final_c[k], final_inds.reshape(-1, 2)[k]), [])
             for k, v in enumerate(stored.reshape(-1))]
    check(all(owned), f"[rj] every stored log L was computed for its walker's sources "
                      f"({sum(owned)} of {len(owned)})")
    fresh = tree_ll(final_c[None], final_inds.reshape(1, nt * nw, 2)).numpy().reshape(nt, nw)
    rel = float(np.max(np.abs(fresh - stored) / np.abs(stored)))
    check(rel <= RJ_FRESH_TOL, f"[rj] final stored vs a fresh evaluation in another batch rel "
                               f"{rel:.3e} <= {RJ_FRESH_TOL}")

    before = np.bincount(inds.sum(-1).ravel(), minlength=3)[1:]
    after = np.bincount(final_inds.sum(-1).numpy().ravel(), minlength=3)[1:]
    per_move = "; ".join(f"{n} {t:.2f} s ({c} calls, {r} rows"
                         + (f", acceptance {acc[n]:.3f})" if n in acc else ")")
                         for n, (t, c, r) in times.items())
    print(f"[rj] from [pe]'s last state cut to {nt} temperatures x {nw} walkers ({PE_ARGS}), "
          f"one branch of 1-2 sources through GlobalLikelihood: step 1 TreeStretchMove + "
          f"DistributionGenerateRJ + tree swaps, step 2 GaussianMove(cov) as TreeGaussianMove + "
          f"MTDistGenMoveRJ(num_try=2); {per_move}; {len(rows)} likelihood calls "
          f"({sum(rows)} rows), fd_dense launches {launches} ({n_1} at B = 1, {n_b} batched); "
          f"walkers with 1 / 2 sources {before[0]} / {before[1]} before, {after[0]} / {after[1]} "
          f"after; {', '.join(f'{k} {v:.3f}' for k, v in fracs.items())}; start log L of the "
          f"one-source walkers vs the PE Likelihood on the same batch max rel {rel_same:.3e} (<= "
          f"{RJ_SAME_BATCH_TOL}), vs [pe]'s stored values (other batches) {rel_pe:.3e}; every "
          f"stored log L finite, 1-2 sources, acceptances in [0, 1], each the value computed for "
          f"its walker's sources; final stored vs a fresh evaluation (another batch) max rel "
          f"{rel:.3e} (<= {RJ_FRESH_TOL}); host clock, synchronized; on {card}", flush=True)
    return dict(tables=seen["tables"], launches=n_b)


def drive_tdi(env, pe_run, fisher):
    """`lisa.tdi.TDIf` on the [pe] injection's channels (the PE template at
    the truth, from [fisher]) on the card against the CPU, and `lisa.mldc` on
    a card tensor of the PE grid against numpy input. No likelihood call."""
    torch, dev, card = env["torch"], env["dev"], env["card"]
    from emri_frequencydomainwaveforms_tpu_torch.lisa import mldc
    from emri_frequencydomainwaveforms_tpu_torch.lisa.tdi import TDIf

    f = pe_run["out"]["f_arr"]
    a, e = fisher["h0"][:2]
    # a second triple with the channels' phases turned, for a cross product
    # with an imaginary part and a nonzero residual
    turn = (complex(np.exp(0.1j)), complex(np.exp(-0.2j)))
    d, h = TDIf.from_aet(f, a, e, 0), TDIf.from_aet(f, a * turn[0], e * turn[1], 0)
    d_c = TDIf.from_aet(f, a.cpu(), e.cpu(), 0)
    h_c = TDIf.from_aet(f, a.cpu() * turn[0], e.cpu() * turn[1], 0)
    check(d.A.device == dev and d.A.dtype == torch.complex128, f"[tdi] channels on {d.A.device}")
    worst = {}
    for name, got, ref in (("normsq", d.normsq(), d_c.normsq()),
                           ("cprod re", d.cprod(h)[0], d_c.cprod(h_c)[0]),
                           ("cprod im", d.cprod(h)[1], d_c.cprod(h_c)[1]),
                           ("logL", d.logL(h), d_c.logL(h_c))):
        got, ref = float(got), float(ref)
        worst[name] = abs(got - ref) / abs(ref)
    self_ll = float(d.logL(d))
    f_t = torch.as_tensor(f, device=dev)
    for name, fn in (("mldc_noisepsd_X", mldc.mldc_noisepsd_X),
                     ("mldc_noisepsd_AE", mldc.mldc_noisepsd_AE),
                     ("mldc_noisepsd_T", mldc.mldc_noisepsd_T),
                     ("mldc_lisanoise", mldc.mldc_lisanoise)):
        got, ref = fn(f_t), fn(f)
        check(got.device == dev and got.dtype == torch.float64, f"[tdi] {name} on {got.device}")
        worst[name] = float(np.max(np.abs(got.cpu().numpy() - ref) / np.abs(ref)))
    summary = ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
    check(all(v <= TDI_TOL for v in worst.values()), f"[tdi] {summary} <= {TDI_TOL}")
    check(self_ll == 0.0, f"[tdi] logL of the injection against itself {self_ll} == 0")
    print(f"[tdi] TDIf.from_aet of the [pe] injection ({len(f)} bins, A = the template's first "
          f"channel, E its second, T = 0) on {d.A.device}: normsq {float(d.normsq()):.6e}, logL "
          f"against itself exactly {self_ll}; card vs CPU and card tensor vs numpy, max rel: "
          f"{summary} (<= {TDI_TOL}); on {card}", flush=True)


def drive_truth(env):
    """The reference test suite's independent truths on the card
    (`testing/truth.py` through `testing/truth_cases.py`, no duration solve:
    every source has a fixed p0), each gated at the reference test's own
    threshold. The golden cases through the general kernel against the
    scipy SPA pipeline; the 1-yr (2,2,0) case again through the banded
    uniform path (the CUDA dense pass at r = 1), held to the general run at
    gate 1's thresholds; harmonic (2, 10) of a real plunging source against
    its brute-force integral, through the general kernel with and without
    its turnover branch and through the banded production kernel (runs of
    16 bins, 4 turnover slots, 2048-run windows); and the plunging source's
    banded evaluation with 4 turnover and 4 negative slots against the
    general kernel. Every dense pass launched here is held to its plain
    version. Returns the r = 16 tables and their launches."""
    torch, dev, card = env["torch"], env["dev"], env["card"]
    wf, fd_dense, summation_fd = env["wf"], env["fd_dense"], env["summation_fd"]
    cases = env["cases"]
    from emri_frequencydomainwaveforms_tpu_torch.testing import truth
    from emri_frequencydomainwaveforms_tpu_torch.testing import truth_cases as tc

    def cplx(o):
        return o[0][0].double().cpu().numpy() + 1j * o[1][0].double().cpu().numpy()

    def launched(what, fn):
        """``fn()`` with the dense pass counted and its tables kept."""
        seen = []
        fd_dense.fd_dense_accumulate.launches = 0
        with dense_function(summation_fd, capturing(fd_dense.fd_dense_accumulate, seen)):
            res = fn()
        torch.cuda.synchronize()
        n = fd_dense.fd_dense_accumulate.launches
        check(n > 0 and n == len(seen), f"[truth] {what}: the fd_dense kernel launched ({n})")
        for k, (groups, r, nf) in enumerate(seen):
            compare(torch, fd_dense, cases, groups, r, nf, f"[truth] {what} call {k}")
        return res, n, seen

    # ---- the golden cases: no device named, the general kernel ----
    for mode, t_years in TRUTH_GOLDEN:
        case = tc.golden_case(mode, t_years)
        check(case["pro"].t_knots.device == dev, f"[truth] golden prologue on {dev}")
        check(np.isfinite(case["golden"]).all() and np.isfinite(case["ours"]).all(),
              f"[truth] golden {mode} finite")
        limit = 1e-5 if t_years == 1.0 else 1e-4  # the 1-yr case: its sanity bound too
        print(f"[truth] golden {mode} at {t_years} yr, general kernel: Hann mismatch "
              f"{case['mm']:.4e} (< {limit:g}), "
              f"interior median pointwise rel {case['median_rel']:.4e} (< 1e-3); on {card}",
              flush=True)
        check(case["mm"] < limit, f"[truth] golden {mode} {t_years} yr mismatch {case['mm']:.3e}")
        check(case["median_rel"] < 1e-3, f"[truth] golden {mode} median {case['median_rel']:.3e}")

    # ---- the 1-yr (2,2,0) case on the banded uniform path ----
    f_g = case["f_grid"]
    nf_g, f0_g, df_g = len(f_g), float(f_g[0]), float(f_g[1] - f_g[0])
    banded, n_golden, _ = launched("golden banded", lambda: wf.fd_waveform_core(
        case["pro"], case["table"], nf_g, channels=False, uniform=(f0_g, df_g)))
    general = wf.fd_waveform_core(case["pro"], case["table"], torch.as_tensor(f_g, device=dev),
                                  channels=False)
    r_g = wf.uniform_bins_per_run(nf_g)
    is_edge = band_edge_mask(wf, case["pro"], case["table"], f_g, df_g, bins_per_run=r_g)
    off, on, _ = split_rel_l2(banded, general, np.arange(nf_g), is_edge)
    mm_b = truth.mismatch(case["golden"], cplx(banded), np.hanning(nf_g))
    print(f"[truth] golden (2, 2, 0) at 1 yr, banded uniform path (r = {r_g}, {nf_g} bins, "
          f"{n_golden} fd_dense launch): vs the general run rel L2 {off:.4e} off the band edges "
          f"(< 1e-3), {on:.4e} on {int(is_edge.sum())} edge bins (< 0.05); golden Hann "
          f"mismatch {mm_b:.4e}; on {card}", flush=True)
    check(off < 1e-3 and on < 0.05, f"[truth] golden banded vs general {off:.3e} / {on:.3e}")
    check(mm_b < 1e-5, f"[truth] golden banded mismatch {mm_b:.3e} < 1e-5")
    del banded, general

    # ---- the real fold: harmonic (2, 10) against its brute-force integral ----
    fold = tc.fold_case()
    fs = torch.as_tensor(fold["fs"], device=dev)
    k1 = cplx(summation_fd.fd_mode_sum(fold["sm"], fs, turnover_slots=1))
    k0 = cplx(summation_fd.fd_mode_sum(fold["sm"], fs, turnover_slots=0))
    kb, n_fold, seen_fold = launched("fold banded", lambda: tc.fold_banded(fold))
    amp = np.abs(fold["bv"]) / fold["scale"]
    rms1, rms0, rms_b = (truth.rms(k, fold) for k in (k1, k0, kb))
    gap = float(np.sqrt(np.mean(np.abs(kb - k1) ** 2)) / fold["scale"])
    print(f"[truth] real fold, harmonic (2, 10) of a plunging source, {len(fs)} fringe bins "
          f"(|brute force| / RMS {amp.min():.3f} .. {amp.max():.3f}): two-branch RMS {rms1:.4e} "
          f"(< 0.12), single branch {rms0:.4e} (> 3x), banded production kernel (r = 16, 4 "
          f"turnover slots, {fold['nf']} bins, {n_fold} fd_dense launch) {rms_b:.4e} (< 0.12), "
          f"banded vs general gap {gap:.4e} (< 2e-2); on {card}",
          flush=True)
    check(amp.min() < 0.5 and amp.max() > 1.3, "[truth] the fold's fringes are present")
    check(rms1 < 0.12 and rms_b < 0.12, f"[truth] fold RMS {rms1:.3e} / banded {rms_b:.3e}")
    check(rms0 > 3 * rms1, f"[truth] single branch {rms0:.3e} > 3 x {rms1:.3e}")
    check(gap < 2e-2, f"[truth] fold banded vs general gap {gap:.3e} < 2e-2")

    # ---- the plunging source: banded with slots against general ----
    (inp, (f0, df, nf), banded_full, b0), n_plunge, seen_pl = launched(
        "plunging banded", tc.plunging_banded)
    check(int(inp.dec_live.sum()) >= 1, "[truth] the plunging source turns over")
    general = summation_fd.fd_mode_sum(
        inp, torch.as_tensor(f0 + df * np.arange(nf), device=dev), turnover_slots=4,
        negative_slots=4)
    rels = []
    for b, g in zip(banded_full, general):
        b, g = b[0].double().cpu().numpy(), g[0].double().cpu().numpy()
        check(np.isfinite(b).all() and np.isfinite(g).all(), "[truth] plunging outputs finite")
        rels.append(float(np.sqrt(np.mean((b - g) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-300)))
    b4, b0 = banded_full[0][0].double().cpu().numpy(), b0[0].double().cpu().numpy()
    adds = float(np.sqrt(np.mean((b4 - b0) ** 2)) / np.sqrt(np.mean(b0**2)))
    print(f"[truth] plunging source banded (r = 16, 4 turnover + 4 negative slots, {nf} bins) "
          f"vs general per channel rel L2 {', '.join(f'{x:.4e}' for x in rels)} (< 2e-2); the "
          f"extra slots add {adds:.4e} (in (1e-4, 0.5)); {n_plunge} fd_dense launches (with and "
          f"without the extra slots); on {card}", flush=True)
    check(max(rels) < 2e-2, f"[truth] plunging banded vs general {max(rels):.3e} < 2e-2")
    check(1e-4 < adds < 0.5, f"[truth] the extra slots add {adds:.3e}")
    return dict(tables_fold=seen_fold[0], launches_fold=n_fold, tables_plunge=seen_pl[0],
                launches_plunge=n_plunge)


# one example in a fresh process: its main() with no arguments, then its
# checks, its dense-pass launches (the count starts at 0 with the process)
# and its seconds as the last line
EXAMPLE_RUNNER = """
import importlib.util, json, os, sys, time
root, name = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense
spec = importlib.util.spec_from_file_location(name, os.path.join(root, "examples", name + ".py"))
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
t0 = time.perf_counter()
checks = module.main([])
torch.cuda.synchronize()
print(json.dumps(dict(checks, launches=fd_dense.fd_dense_accumulate.launches,
                      seconds=time.perf_counter() - t0)))
"""


def drive_examples(env, beside, timeout_s=600):
    """The port's three examples as a user runs them (``main()`` with no
    arguments: the current CUDA device, the CI-quick default sizes), each in
    a process of its own, the three at once, the kernels already built,
    while ``beside()`` runs in this process (a phase whose times are not
    metrics). Prints each one's own lines, its checks, launches and seconds,
    and gates them: each exits 0 (the examples keep their originals'
    asserts) and its checks hold. Returns ``beside()``'s result. A child
    still running when this returns or raises is killed."""
    import tempfile

    card = env["card"]
    root = os.path.dirname(os.path.abspath(__file__))
    children = []
    try:
        for name in EXAMPLES:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            proc = subprocess.Popen([sys.executable, "-c", EXAMPLE_RUNNER, root, name],
                                    cwd=root, stdout=out, stderr=err)
            children.append((name, proc, out, err))
        beside_out = beside()
        for _, proc, _, _ in children:
            proc.wait(timeout=timeout_s)
    finally:
        for _, proc, _, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, proc, stdout, stderr in children:
        rc = proc.returncode
        stdout.seek(0)
        stderr.seek(0)
        lines = stdout.read().splitlines()
        if rc != 0 or not lines:
            print(stderr.read()[-4000:], flush=True)
        check(rc == 0 and bool(lines), f"[examples] examples/{name}.py exited {rc}")
        result = json.loads(lines[-1])
        for line in lines[:-1]:
            print(f"[examples] {name}: {line}", flush=True)
        launches, secs = result.pop("launches"), result.pop("seconds")
        summary = ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in result.items())
        print(f"[examples] examples/{name}.py main(): {summary}; {launches} fd_dense launches; "
              f"{secs:.1f} s in its own process beside the other two and [moves]; on {card}",
              flush=True)
        check(all(np.isfinite(v) for v in result.values()), f"[examples] {name} checks finite")
        out[name] = dict(result, launches=launches)
    quick = out["torch_quickstart"]
    check(quick["finite"] and quick["nonzero_bins"] > 0 and 1e-21 < quick["peak_hp"] < 1e-15,
          f"[examples] quickstart spectrum {quick}")
    constr = out["torch_fd_construction"]
    check(constr["mismatch"] < constr["gate"] and abs(constr["ratio_median"] - 1.0) < 0.05,
          f"[examples] fd_construction {constr}")
    tut = out["torch_fd_waveforms_tutorial"]
    check(tut["overlap"] > 0.99 and tut["mm_windowed"] < 1e-2 and tut["collapse"] < 1e-2
          and tut["downsample_rel"] < 1e-3 and 0.0 < tut["frac_220"] < 1.0,
          f"[examples] tutorial {tut}")
    check(quick["launches"] > 0 and tut["launches"] > 0,
          "[examples] the banded examples launched the fd_dense kernel")
    return beside_out


# [tools] and [matrix] run in processes of their own: the child process
# calls chip_smoke.<fn>(spec), which prints its lines and marks each of its
# results with CHILD_RESULT
CHILD_RUNNER = """
import json, sys
root, fn, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, root)
import chip_smoke
getattr(chip_smoke, fn)(spec)
"""
CHILD_RESULT = "@result "


def child_result(obj):
    """Print one result of a child phase, for `finish_child`."""
    print(CHILD_RESULT + json.dumps(obj), flush=True)


def start_child(fn, spec, env=None):
    """Start ``chip_smoke.fn(spec)`` in a process of its own, its stdin a
    pipe: (process, stdout, stderr). A child still running when this
    script exits is killed."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", CHILD_RUNNER, root, fn, json.dumps(spec)],
                            cwd=root, stdin=subprocess.PIPE, stdout=out, stderr=err, text=True,
                            env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, err


def tell_child(child, word):
    """One line to a child's stdin, if it still runs (`finish_child` reports
    a child that ended early)."""
    proc = child[0]
    try:
        if proc.poll() is None:
            proc.stdin.write(word + "\n")
            proc.stdin.flush()
    except BrokenPipeError:
        pass


def finish_child(child, phase, timeout_s):
    """Wait for a child phase, relay its lines and return its results in
    order. Fails unless it exited 0 with a result; a child still running
    after ``timeout_s`` is killed."""
    proc, stdout, stderr = child
    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stdout.seek(0)
    stderr.seek(0)
    results = []
    for line in stdout.read().splitlines():
        if line.startswith(CHILD_RESULT):
            results.append(json.loads(line[len(CHILD_RESULT):]))
        else:
            print(line, flush=True)
    ok = proc.returncode == 0 and bool(results)
    if not ok:
        print(stderr.read()[-4000:], flush=True)
    check(ok, f"[{phase}] the {phase} process exited {proc.returncode}")
    return results


# [tools]: the root-level tools' torch twins (tools/torch_*.py,
# tools/rwz/torch_*.py), in a process of their own beside [moves]
TOOLS_THREADS = 2  # the child's intra-op threads, beside [moves] and [examples]
TOOLS_RECORD_RUNS = (32, 16)  # the xcheck's bins per run whose launches are kernel records
# per-knot mode powers, card against CPU on the card's knots: the weak
# harmonics that carry the negative-f and high-l power keep the float32
# projection's order-dependent noise (2.80e-05 / 9.50e-06 on an H100)
TOOLS_KNOT_TOL = 1e-4
TOOLS_HOLDOUT_TOL = 1e-5  # held-out deviations, card against CPU, absolute
TOOLS_FLUX_TOL = 5e-5  # B_lm's F_model (float32 projection), card against CPU
TOOLS_F64_TOL = 1e-12  # model_amplitudes_f64, of the node's largest amplitude
TOOLS_MM_TOL = 1e-3  # the l 4/6 mismatch, card against CPU, relative
TOOLS_HOLDOUT = ((2, 2, 0), 3)  # the held-out mode and its midpoints


def tools_child(spec):
    """The [tools] phase, in its own process: each twin's per-source or
    per-node functions on the card, held against the same functions on the
    CPU, the xcheck twin at full width with its dense-pass launches counted
    and its r = 32 / r = 16 tables saved for the kernel records, and the
    ecc table's re-clean from the raw solve. Prints its lines and its
    numbers as its result; every check raises."""
    import tempfile

    import torch

    torch.set_num_threads(TOOLS_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models import waveform as wf
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import schwarz_ecc_flux_inspiral
    from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense
    from emri_frequencydomainwaveforms_tpu_torch.testing import fd_dense_cases as cases
    from tools import torch_convergence_l56 as l56
    from tools import torch_negative_f_survey as neg
    from tools import torch_xcheck_diag as xcheck
    from tools.rwz import torch_calibrate as cal
    from tools.rwz import torch_calibrate_ecc as ecc
    from tools.rwz import torch_holdout_check as holdout
    from tools.rwz.eccentric import darwin_orbit

    dev, card = torch.device(spec["device"]), spec["card"]
    m_big, mu, e0, p0 = spec["source"]
    out, t_start = {}, time.perf_counter()

    def say(text):
        print(f"[tools] {text}; on {card}", flush=True)

    # ---- the xcheck twin at full width: gate 1's configuration ----
    t0 = time.perf_counter()
    f_np = xcheck.positive_grid()
    nf, dfu = len(f_np), float(f_np[1] - f_np[0])
    pro, table_k = xcheck.gate1_prologue(dev)
    sub = np.arange(0, nf, 617)
    seen = []
    fd_dense.fd_dense_accumulate.launches = 0
    with dense_function(summation_fd, capturing(fd_dense.fd_dense_accumulate, seen)):
        banded = {r: xcheck.banded(pro, table_k, f_np, sub, r) for r in (64, 32, 16)}
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    check(launches == len(seen) == 3, f"[tools] xcheck: 3 fd_dense launches ({launches})")
    general = {s: xcheck.general(pro, table_k, f_np[sub], s) for s in (32, 64)}
    xcheck_s = time.perf_counter() - t0
    tables_path = os.path.join(spec["tables_dir"], "tables.pt")
    saved = {}
    for groups, r, nf_t in seen:
        if r not in TOOLS_RECORD_RUNS:
            continue
        err, scale = compare(torch, fd_dense, cases, groups, r, nf_t, f"[tools] xcheck r = {r}")
        saved[f"r{r}"] = dict(groups=[tuple(x.cpu() for x in g) for g in groups], r=r, nf=nf_t)
        say(f"xcheck banded r = {r} at 1 yr ({nf_t} bins, {groups[0].pc.shape[1]} + "
            f"{groups[1].pc.shape[1] if len(groups) > 1 else 0} slots of "
            f"{groups[0].pc.shape[2]} runs, B = 1): kernel vs plain max|diff| {err:.3e} "
            f"(rel {err / scale:.3e} <= 1e-5)")
    torch.save(saved, tables_path)
    is_edge = band_edge_mask(wf, pro, table_k, f_np[sub], dfu)
    off = max(float(np.sqrt(np.mean((b[~is_edge] - g[~is_edge]) ** 2)) / np.sqrt(np.mean(b**2)))
              for b, g in zip(banded[64], general[32]))
    base = xcheck.rel(banded[64], general[32])
    rows = xcheck.ablation(banded[64], banded[32], banded[16], general[32], general[64])
    check(all(np.isfinite(x).all() for v in (*banded.values(), *general.values()) for x in v),
          "[tools] xcheck outputs finite")
    say(f"xcheck_diag twin (1 yr, rwz, {len(table_k.ls)} slots, {len(sub)} bins, "
        f"{launches} fd_dense launches at r = 64, 32, 16): baseline banded(r=64) vs "
        f"general(s=32) {base:.3e} over all bins, {off:.4e} off the band edges (< 1e-3, gate 1); "
        + "; ".join(f"{label} {value:.3e}" for label, value in rows)
        + f"; {xcheck_s:.1f} s")
    check(off < 1e-3, f"[tools] xcheck baseline off the band edges {off:.3e} < 1e-3")
    out.update(launches={f"r{r}": sum(1 for _, r_t, _ in seen if r_t == r)
                         for r in TOOLS_RECORD_RUNS},
               tables_path=tables_path, xcheck_baseline=base,
               xcheck_off_edges=off, xcheck_ablation=dict(rows))
    del banded, general, pro, seen

    # ---- the negative-f survey's and power_by_l's per-source physics ----
    def knots(t_years, max_steps):
        traj = schwarz_ecc_flux_inspiral(m_big, mu, p0, e0, t_years=t_years, max_steps=max_steps,
                                         device=dev)
        return traj, int(traj.n[0])

    table = default_mode_table(30)
    traj, n = knots(1.0, 512)
    p_k, e_k = traj.p[0, :n], traj.e[0, :n]
    frac = neg.knot_negative_fraction(p_k, e_k, table)
    frac_cpu = neg.knot_negative_fraction(p_k.cpu(), e_k.cpu(), table)
    frac_e2e = neg.negative_fraction(m_big, mu, p0, e0, 1.0, table, device="cpu")
    gap = abs(frac / frac_cpu - 1.0)
    say(f"negative_f_survey twin at the [pe] source (M {m_big:g}, mu {mu:g}, e0 {e0}, p0 "
        f"{p0:.6f}, 1 yr, {n} knots): negative-f power fraction {frac:.6e} on the card, "
        f"{frac_cpu:.6e} on the CPU on the card's knots (rel {gap:.2e} <= {TOOLS_KNOT_TOL:g}), "
        f"{frac_e2e:.6e} on the CPU's own trajectory")
    check(0.0 <= frac < 1e-4 and gap <= TOOLS_KNOT_TOL, f"[tools] survey fraction {frac:.3e}")
    table_hi = default_mode_table(20, l_max=10)
    traj, _ = knots(l56.T_DRAW, 256)
    live = (torch.arange(traj.t.shape[1], device=dev) < traj.n[0]).to(traj.t.dtype)
    th, ph = l56.CASES[0][3:]
    pb = l56.knot_power_by_l(traj.p[0], traj.e[0], live, th, ph, table_hi)
    pb_cpu = l56.knot_power_by_l(traj.p[0].cpu(), traj.e[0].cpu(), live.cpu(), th, ph, table_hi)
    gap_l = max(abs(pb[l] / pb_cpu[l] - 1.0) for l in pb)
    tot = sum(pb.values())
    say(f"convergence_l56 twin power_by_l at the [pe] source ({l56.T_DRAW} yr, "
        f"{int(traj.n[0])} knots, {table_hi.num_modes} modes): l = 5,6 / 7,8 / 9,10 power "
        f"fractions {(pb[5] + pb[6]) / tot:.4e} / {(pb[7] + pb[8]) / tot:.4e} / "
        f"{(pb[9] + pb[10]) / tot:.4e}; card vs CPU on the card's knots worst l rel "
        f"{gap_l:.2e} (<= {TOOLS_KNOT_TOL:g})")
    check(gap_l <= TOOLS_KNOT_TOL and pb[2] > pb[6] > pb[10] > 0.0, "[tools] power_by_l")
    mm = l56.fd_mismatch_lpair(m_big, mu, p0, e0, th, ph, l56.T_CASE, device=dev)
    mm_cpu = l56.fd_mismatch_lpair(m_big, mu, p0, e0, th, ph, l56.T_CASE, device="cpu")
    gap_mm = abs(mm / mm_cpu - 1.0)
    say(f"convergence_l56 twin fd_mismatch_lpair l 4/6 at the [pe] source ({l56.T_CASE} yr, "
        f"60000 bins, general kernel): {mm:.6e} on the card, {mm_cpu:.6e} on the CPU "
        f"(rel {gap_mm:.2e} <= {TOOLS_MM_TOL:g})")
    check(0.0 < mm < 1e-2 and gap_mm <= TOOLS_MM_TOL, f"[tools] l 4/6 mismatch {mm:.3e}")
    out.update(neg_fraction=frac, power_by_l=pb, mismatch_l46=mm)
    del traj, live

    # ---- the calibrators' model sides ----
    table_b = default_mode_table(2, l_max=8)
    pairs, xs = cal.calibration_pairs(table_b), cal.x_grid()
    fm = cal.model_flux_modes(pairs, xs, table_b, dev)
    fm_cpu = cal.model_flux_modes(pairs, xs, table_b, "cpu")
    gap_b = float(np.max(np.abs(fm / fm_cpu - 1.0)))
    say(f"calibrate twin F_model over the {len(xs)}-point x grid for {len(pairs)} (l, m) "
        f"families, one batch: card vs CPU worst rel {gap_b:.2e} (<= {TOOLS_FLUX_TOL:g})")
    check(np.isfinite(fm).all() and gap_b <= TOOLS_FLUX_TOL, f"[tools] F_model {gap_b:.3e}")
    from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_ecc_data as ecc_data

    table_e = default_mode_table(12, l_max=6)
    worst_a, n_nodes = 0.0, 0
    for i in range(0, ecc_data.N_U, 3):
        for j in range(0, ecc_data.N_E, 3):
            u, e = ecc_data.U0 + i * ecc_data.DU, ecc_data.E0 + j * ecc_data.DE
            p = ecc.p_of_node(u, e)
            orb = darwin_orbit(p, float(e), 1024 if i < ecc_data.N_U // 3 else 512)
            args = (p, float(e), orb, table_e, table_e.ls, table_e.ms, table_e.ns)
            a = ecc.model_amplitudes_f64(*args, device=dev)
            a_cpu = ecc.model_amplitudes_f64(*args, device="cpu")
            worst_a = max(worst_a, float(np.max(np.abs(a - a_cpu)) / np.max(np.abs(a_cpu))))
            n_nodes += 1
    say(f"calibrate_ecc twin model_amplitudes_f64 at {n_nodes} nodes of the {ecc_data.N_U} x "
        f"{ecc_data.N_E} (u, e) grid, {table_e.num_modes} modes: card vs CPU worst "
        f"{worst_a:.2e} of the node's largest amplitude (<= {TOOLS_F64_TOL:g})")
    check(worst_a <= TOOLS_F64_TOL, f"[tools] model_amplitudes_f64 {worst_a:.3e}")
    raw = os.path.join(spec["root"], "tools", "rwz", "_rwz_ecc_data_raw.npz")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ecc.py")
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            rows_raw, _ = ecc.from_raw(raw, path)
    n_e_raw = next(iter(rows_raw.values())).shape[1]
    inner = max(float(np.max(np.abs(r[:, :-1] - ecc_data.R_TABLE[k][:, :n_e_raw - 1])))
                for k, r in rows_raw.items())
    edge = max(float(np.max(np.abs(r[:, -1] - ecc_data.R_TABLE[k][:, n_e_raw - 1])))
               for k, r in rows_raw.items())
    say(f"calibrate_ecc twin --from-raw (tools/rwz/_rwz_ecc_data_raw.npz, {len(rows_raw)} rows "
        f"of {ecc_data.N_U} x {n_e_raw}) against the committed {len(ecc_data.R_TABLE)}-row "
        f"{ecc_data.N_U} x {ecc_data.N_E} table: max |dR| {inner:.2e} on the first "
        f"{n_e_raw - 1} e-columns (<= 1e-9: the committed table's 10-digit text), {edge:.3e} on "
        f"column {n_e_raw - 1}, whose neighbours the extension's columns changed")
    check(inner <= 1e-9, f"[tools] from-raw vs committed table {inner:.3e}")

    # ---- one held-out mode at a few midpoints (the RWZ solve on the host) ----
    key, n_mid = TOOLS_HOLDOUT
    table_h = default_mode_table(12, l_max=4)
    mode_idx = ecc.mode_index(table_h, [key[:2]], [key[2]])
    devs = []
    for u, e in list(zip(*holdout.midpoints(6)))[:n_mid]:
        d, a = holdout.midpoint_devs(u, e, table_h, mode_idx, dev)[key]
        d_cpu, a_cpu = holdout.midpoint_devs(u, e, table_h, mode_idx, "cpu")[key]
        check(abs(d - d_cpu) <= TOOLS_HOLDOUT_TOL and abs(a - a_cpu) <= TOOLS_HOLDOUT_TOL,
              f"[tools] holdout {key} card vs CPU")
        devs.append((d, a))
    say(f"holdout_check twin {key} at {n_mid} midpoints: R dev "
        f"{', '.join(f'{d:.2e}' for d, _ in devs)}, amp dev "
        f"{', '.join(f'{a:.2e}' for _, a in devs)} (card = CPU within {TOOLS_HOLDOUT_TOL:g})")
    check(np.isfinite(devs).all(), "[tools] holdout deviations finite")
    out.update(holdout=devs, seconds=time.perf_counter() - t_start)
    child_result(out)


def start_tools(env, pe):
    """Start the [tools] child on the [pe] source: (the child, the directory
    its tables go to)."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tables_dir = tempfile.mkdtemp()
    spec = dict(root=root, device=str(env["dev"]), card=env["card"], tables_dir=tables_dir,
                source=[1e6, 10.0, 0.35, float(pe["out"]["p0"])])
    return start_child("tools_child", spec), tables_dir


def finish_tools(env, child, timeout_s=600):
    """Wait for the [tools] child, relay its lines and load its tables onto
    the card."""
    import shutil

    torch = env["torch"]
    child, tables_dir = child
    result = finish_child(child, "tools", timeout_s)[-1]
    saved = torch.load(result["tables_path"])
    shutil.rmtree(tables_dir, ignore_errors=True)
    fd_dense, dev = env["fd_dense"], env["dev"]
    result["tables"] = {
        name: ([fd_dense.DenseGroup(*(x.to(dev) for x in g)) for g in rec["groups"]], rec["r"],
               rec["nf"])
        for name, rec in saved.items()
    }
    print(f"[tools] {result['seconds']:.1f} s in its own process beside [moves] and "
          f"[examples]; on {env['card']}", flush=True)
    return result


# [matrix]: tools/test_matrix.sh's paper-source rows (the torch twin,
# tools/torch_test_matrix.py) at full size, in a process of its own from
# the end of [scan] to the kernel records: 4 yr, -downsample 0 (6,311,629
# positive bins, 12.6M samples), 16
# walkers, one sampler step, the production physics. One duration solve
# (get_p_at_t, 44 dp5 trajectories) feeds every row, as [mesh] reuses
# [pe]'s p0. Row 1: TD template, windowed TD injection; row 3: FD template,
# the same injection
MATRIX_ROWS = (1, 3)
MATRIX_THREADS = 2  # the child's intra-op threads, beside [moves], [examples] and [tools]
MATRIX_LL_TOL = 1e-3  # |log L(truth)| where a template is its own injection (tests/test_torch_pe.py)
MATRIX_SNR_TOL = 1e-12  # rows 1 and 3: one TD injection, relative


def matrix_child(spec):
    """The [matrix] phase, in its own process: the duration solve of the
    paper source, then each row of ``spec["rows"]`` through the twin's
    `run_pe` with that p0, its fd_dense launches counted per batch size and
    the first tables of each size kept; rows 1 and 3 must read one SNR; the
    kernel against its plain version on those tables; where h5py imports,
    row 3's HDF chain file resumed for one more step. Reads one line on
    stdin between the solve and the rows (the main process's [pe] done) and
    one before its kernel records (the main process idle); prints its
    lines, its rows and then its records as results, and exits. Every
    check raises."""
    import shutil
    import tempfile

    import torch

    torch.set_num_threads(MATRIX_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.hdf import HDFBackend
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler
    from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import flux_model, get_p_at_t
    from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense
    from emri_frequencydomainwaveforms_tpu_torch.testing import fd_dense_cases as cases
    from tools import torch_test_matrix as tm

    dev, card = torch.device(spec["device"]), spec["card"]
    env = dict(torch=torch, dev=dev, card=card, fd_dense=fd_dense, cases=cases)
    t_start = time.perf_counter()

    def say(text):
        print(f"[matrix] {text}; on {card}", flush=True)

    rows = tm.row_flags()
    first = tm.pe_args(rows[spec["rows"][0] - 1][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = flux_model(first.flux, dev)
    p0 = float(get_p_at_t(first.M, first.mu, first.e0, 0.99 * first.Tobs, flux=first.flux,
                          flux_grid=grid, device=dev)[0])
    solve_s = time.perf_counter() - t0
    say(f"duration solve of the paper source (M {first.M}, mu {first.mu}, e0 {first.e0}, "
        f"{first.Tobs} yr, flux {first.flux}): p0 {p0:.9f} in {solve_s:.1f} s, for every row")
    # the rows' heavy batches wait for the end of [pe], whose times are printed
    t0 = time.perf_counter()
    check(sys.stdin.readline() == "rows\n", "[matrix] the main process ended before [pe] did")
    say(f"rows released after [pe] ({time.perf_counter() - t0:.1f} s after the solve)")
    h5 = tm.have_h5py()
    if not h5:
        say("chain backend: memory (h5py absent)")
    outdir = tempfile.mkdtemp(prefix="matrix_") if h5 else None
    # per (B, nf): the first tables and the row that launched them, and
    # the launches of each row
    kept, counts, out_rows = {}, {}, {}

    def keep_first(groups, *, r, nf):
        key = (groups[0].pc.shape[0], nf)
        kept.setdefault(key, (groups, r, row_now))
        counts.setdefault(key, {})
        counts[key][row_now] = counts[key].get(row_now, 0) + 1
        return fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)

    try:
        for i in spec["rows"]:
            row_now, argv = i, rows[i - 1][1]
            fd_dense.fd_dense_accumulate.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            hdf = h5 and i == 3
            with dense_function(summation_fd, keep_first):
                out = tm.run_pe(argv, dev, outdir if hdf else None,
                                None if hdf else Backend(), p0=p0)
            torch.cuda.synchronize()
            launches = fd_dense.fd_dense_accumulate.launches
            by_batch = {key[0]: n[i] for key, n in sorted(counts.items()) if i in n}
            check(sum(by_batch.values()) == launches,
                  f"[matrix] row {i}: every fd_dense launch came through the path ({by_batch}, "
                  f"{launches})")
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            ll = out["backend"].get_log_like()
            args = tm.pe_args(argv)
            say(f"row {i} ({' '.join(argv)}): p0 {out['p0']:.9f}, {out['n_knots']} knots, nf "
                f"{out['nf']}, injection SNR {out['snr']:.6f}, log L at the truth "
                f"{out['ll_truth']:.6e}, stored log L {float(ll.min()):.6e} .. "
                f"{float(ll.max()):.6e}, {launches} fd_dense launches ("
                f"{', '.join(f'B = {b}: {n}' for b, n in by_batch.items()) or 'none'}), "
                f"{'HDF chain file' if hdf else 'in-memory chain'}; {out['seconds']:.1f} s "
                f"({tm.stages(out)}), peak device memory {peak:.2f} GB")
            check(out["p0"] == p0, f"[matrix] row {i} p0 from the shared solve")
            check(bool(np.isfinite(out["chain"]).all() and np.isfinite(ll).all()
                       and np.isfinite(out["ll_truth"])), f"[matrix] row {i} chain and log L finite")
            if args.injectFD:
                check(abs(out["ll_truth"]) < MATRIX_LL_TOL,
                      f"[matrix] row {i} |log L(truth)| {abs(out['ll_truth']):.3e}")
            n_b = args.nwalkers * args.ntemps
            if args.template == "fd":
                check(launches > 0 and (n_b, out["nf"]) in kept,
                      f"[matrix] row {i}: the batched fd_dense kernel ran ({launches} launches)")
            else:
                check(launches == 0, f"[matrix] row {i}: the TD template launches no fd_dense")
            out_rows[i] = dict(snr=out["snr"], ll_truth=out["ll_truth"], seconds=out["seconds"],
                               peak_gb=peak, launches=launches, nf=out["nf"], batch=n_b,
                               launches_by_batch={str(b): n for b, n in by_batch.items()},
                               downsample=args.downsample, ll_step1=ll[0].copy())
            del out
        if 1 in out_rows and 3 in out_rows:
            a, b = out_rows[1]["snr"], out_rows[3]["snr"]
            check(abs(a / b - 1.0) <= MATRIX_SNR_TOL,
                  f"[matrix] rows 1 and 3 share one TD injection: SNR {a:.12f} / {b:.12f}")
            say(f"rows 1 and 3 read one injection SNR: {a:.12f} / {b:.12f}")

        # the kernel at the new sizes against its plain version
        for (n_b, nf), (groups, r, _) in sorted(kept.items()):
            err, scale = compare(torch, fd_dense, cases, groups, r, nf,
                                 f"[matrix] fd_dense B={n_b} nf={nf}")
            say(f"fd_dense B = {n_b}, r = {r}, {groups[0].pc.shape[1]} slots of "
                f"{groups[0].pc.shape[2]} runs, nf {nf}: kernel vs plain max|diff| {err:.3e} "
                f"(rel {err / scale:.3e} <= 1e-5)")

        if h5 and 3 in out_rows:
            # the CLI's resume branch on row 3's chain file, one more step
            path = os.path.join(outdir, os.path.basename(tm.pe_args(rows[2][1]).outname))
            before = HDFBackend(path)
            last = before.get_last_sample()
            check(before.iteration == 1, f"[matrix] row 3 chain file at iteration {before.iteration}")
            seen = []
            coerce = EnsembleSampler._coerce_state

            def recording(self, s):
                st = coerce(self, s)
                seen.append(st)
                return st

            with patched(EnsembleSampler, "_coerce_state", recording):
                resumed = tm.run_pe(rows[2][1], dev, outdir, None, p0=p0)
            after = HDFBackend(path)
            st = seen[0]
            same_start = (torch.equal(st.branches["emri"].coords, last.branches["emri"].coords)
                          and torch.equal(st.log_like, last.log_like)
                          and st.random_state == last.random_state)
            ll_file = after.get_log_like()
            same_step1 = bool(np.array_equal(ll_file[0], out_rows[3]["ll_step1"]))
            say(f"resume of row 3's HDF chain file for one more step: iteration "
                f"{before.iteration} -> {after.iteration}, resumed from the file's last sample "
                f"{same_start}, the file's first-step log L equal to the uninterrupted run's "
                f"{same_step1}, new step's log L finite {bool(np.isfinite(ll_file[1]).all())}; "
                f"{resumed['seconds']:.1f} s")
            check(after.iteration == 2 and same_start and same_step1
                  and bool(np.isfinite(ll_file[1]).all()), "[matrix] HDF resume")
            del resumed
    finally:
        if outdir is not None:
            shutil.rmtree(outdir, ignore_errors=True)
    seconds = time.perf_counter() - t_start
    say(f"{seconds:.1f} s in its own process")
    child_result(dict(rows={str(k): {n: v for n, v in r.items() if n != "ll_step1"}
                            for k, r in out_rows.items()},
                      p0=p0, solve_s=solve_s, seconds=seconds))

    # the kernel records, timed once the main process waits on this one
    check(sys.stdin.readline() == "records\n", "[matrix] the main process ended")
    # each size named by the row that launched its tables, with the
    # launches at that size over the phase's rows
    records = []
    for (n_b, nf), (groups, r, i) in sorted(kept.items()):
        ds = out_rows[i]["downsample"]
        name = (f"fd_dense_accumulate_batched[matrix-ds{ds}-B{n_b}]" if n_b > 1
                else f"fd_dense_accumulate[matrix-ds{ds}]")
        n_launched = sum(counts[(n_b, nf)].values())
        rec = dense_record(env, groups, r, nf, name, 203 if n_b > 1 else 99, n_launched, 10)
        rec["batch"] = n_b
        records.append(rec)
    child_result(records)


def start_matrix(env):
    """Start the [matrix] child."""
    spec = dict(device=str(env["dev"]), card=env["card"], rows=list(MATRIX_ROWS))
    # its row batches share the card with the later phases: expandable
    # segments keep its cache from fragmenting between the two rows
    return start_child("matrix_child", spec,
                       dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))


def finish_matrix(child, timeout_s=1200):
    """Let the [matrix] child time its kernel records (this process idle),
    wait for it and relay its lines. Returns its result with the records."""
    tell_child(child, "records")
    results = finish_child(child, "matrix", timeout_s)
    check(len(results) == 2, f"[matrix] {len(results)} results, not the rows and the records")
    return dict(results[0], records=results[1])


def drive_mesh(env, grid):
    """Walker and frequency sharding on the card, at the PE likelihood's full
    width (`testing/pe_mesh.py`; p0 fixed, no duration solve): 16 walkers
    around the injection in one process at B = 16, then, in MESH_RANKS
    ranks spawned once (all on this card, exchanging through gloo), by
    walker shards (4 ranks x 4 walkers) and on a 2 x 2 walker x frequency
    mesh (each rank's template on its half of the bins), then walkers 0 and
    5 alone. Every walker's live knots must be equal across the
    evaluations, its log L and template within MESH_TOL of the batch of 16.
    The same ranks then run `graft_entry.dryrun_rank`, checked by
    `check_dryrun`. Returns rank 0's dense-pass tables (its walkers' rows of
    the batch of 16's) and every rank's fd_dense launches. The one-process
    batches and the dry run's replay run here while the ranks start up."""
    torch, dev, card = env["torch"], env["dev"], env["card"]
    from emri_frequencydomainwaveforms_tpu_torch.graft_entry import check_dryrun, dryrun_replay
    from emri_frequencydomainwaveforms_tpu_torch.parallel.mesh import start_ranks
    from emri_frequencydomainwaveforms_tpu_torch.testing import batch_dependence, pe_mesh

    t0 = time.perf_counter()
    spec = pe_mesh.pe_problem(batch_dependence.PE_ARGS, batch_dependence.P0, dev, grid)
    parent_s = {"injection": time.perf_counter() - t0}
    host_grid = None if grid is None else grid._replace(values=grid.values.cpu())
    # the ranks start now; this process's own work overlaps their start-up
    # (beside ranks already computing on the same card it took ~4x longer,
    # NVIDIA H100 80GB HBM3, 700 W)
    handle = start_ranks(pe_mesh.mesh_rank, MESH_RANKS, (spec, host_grid, None), backend="gloo")
    like, last = pe_mesh.pe_likelihood(spec, dev, grid)
    x = torch.as_tensor(spec["x"])
    n = x.shape[0]

    def evaluate(rows):
        ll = like(x[rows]).cpu()
        return dict(ll=ll, n_live=last["n_live"], template=last["template"])

    seen = []
    with dense_function(env["summation_fd"], capturing(env["fd_dense"].fd_dense_accumulate, seen)):
        one = evaluate(list(range(n)))
    alone = {k: evaluate([k]) for k in (0, 5)}
    parent_s["B = 16 and 1"] = time.perf_counter() - t0 - sum(parent_s.values())
    replay = dryrun_replay(MESH_RANKS, dev)
    parent_s["replay"] = time.perf_counter() - t0 - sum(parent_s.values())
    ranks = handle.join()
    parent_s["waiting for the ranks"] = time.perf_counter() - t0 - sum(parent_s.values())
    evals = {f"{MESH_RANKS} ranks x {n // MESH_RANKS}": ranks["walker"],
             f"{MESH_RANKS // 2} x 2 walker x freq": ranks["composed"]}
    for k, ev in alone.items():
        evals[f"walker {k} alone"] = ev
    worst_ll, worst_t, all_exact = 0.0, 0.0, True
    for k in range(n):
        parts = []
        for name, ev in evals.items():
            if name.startswith("walker ") and not name.startswith(f"walker {k} "):
                continue
            i = 0 if name.startswith("walker ") else k
            knots, ll, tmpl = int(ev["n_live"][i]), float(ev["ll"][i]), ev["template"][i]
            check(knots == int(one["n_live"][k]),
                  f"[mesh] walker {k}: {knots} knots in '{name}', {int(one['n_live'][k])} at B = {n}")
            rel_ll = abs(ll - float(one["ll"][k])) / abs(float(one["ll"][k]))
            rel_t = float((tmpl.double() - one["template"][k].double()).abs().max()
                          / one["template"][k].double().abs().max())
            exact = ll == float(one["ll"][k]) and bool(torch.equal(tmpl, one["template"][k]))
            worst_ll, worst_t = max(worst_ll, rel_ll), max(worst_t, rel_t)
            all_exact = all_exact and exact
            parts.append(f"{name}: {knots} knots, log L rel {rel_ll:.3e}, template {rel_t:.3e} "
                         f"max/scale ({'bit-exact' if exact else 'not bit-exact'})")
        print(f"[mesh] walker {k} (B = {n}: {int(one['n_live'][k])} knots, log L "
              f"{float(one['ll'][k]):.10e}): " + "; ".join(parts), flush=True)
    check(worst_ll <= MESH_TOL and worst_t <= MESH_TOL,
          f"[mesh] log L rel {worst_ll:.3e}, template {worst_t:.3e} <= {MESH_TOL}")
    per_rank = [int(v) for v in ranks["launches"]]
    check(all(v > 0 for v in per_rank), f"[mesh] every rank launched fd_dense ({per_rank})")
    dry = check_dryrun({**ranks["dryrun"], **replay}, MESH_RANKS)
    mesh_s = time.perf_counter() - t0
    print(f"[mesh] PE likelihood ({batch_dependence.PE_ARGS}; p0 {batch_dependence.P0}) on {n} "
          f"walkers, each evaluation against the batch of {n} in one process: equal knots, "
          f"worst log L rel {worst_ll:.3e}, worst template {worst_t:.3e} max/scale (<= "
          f"{MESH_TOL}), {'every match bit-exact' if all_exact else 'not every match bit-exact'}; "
          f"ranks on {ranks['device']} (rank 0) through gloo, fd_dense launches per rank in the "
          f"walker-sharded evaluation {per_rank}; composed bins of rank 0 {ranks['composed']['bins']}; "
          f"dry run composed chain {'bit-exact' if dry.get('exact') else 'within 1e-12'}; "
          f"seconds, this process: {', '.join(f'{k} {v:.1f}' for k, v in parent_s.items())}; "
          f"rank 0 (after its spawn): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in ranks['seconds'].items())}; phase "
          f"{mesh_s:.1f} s; host clock; on {card}",
          flush=True)
    # rank 0's tables: its walkers' rows of the batch of 16's, the same to
    # the bit (the rows do not depend on the batch, as checked above)
    groups, r, nf = seen[0]
    rank0 = n // MESH_RANKS
    groups = [env["fd_dense"].DenseGroup(*(t[:rank0].contiguous() for t in g)) for g in groups]
    return dict(tables=(groups, r, nf), launches=sum(per_rank), per_rank=per_rank)


def row_records(torch, card, pe):
    """Each row kernel of the PE path on the inputs its call sites got in
    [pe]'s timed likelihood call: against its plain version (the PyTorch
    call it stands in for, which is also the library call), timed beside
    both and its bound. A sum of n terms in any order lies within
    (n - 1) u sum|terms| of the exact one (u the unit roundoff): a row sum
    must agree with the plain one within 2 n u max sum|terms|, and each
    element j of a running sum with the float64 running sum of its input
    within 2 (j + 1) u sum_{j' <= j} |x_j'|, so that a scan that drops or
    shifts a term fails at the first element it touches. Each kernel must
    also equal its order model (testing/row_order.py, every addition of
    csrc/row_ops.cu replayed in torch) bit for bit. Times: CUDA events per
    call in a loop of calls, beside the profiler's device time per call;
    where the events read well over the device time, the host's launch
    path sets the rate. Returns the kernel records, each with its call
    site's launches in the [pe] run."""
    from emri_frequencydomainwaveforms_tpu_torch.testing.row_order import (row_cumsum_order,
                                                                           row_sum_order)

    plain_of = {"row_sum": lambda x, mean=False: torch.mean(x, -1) if mean else torch.sum(x, -1),
                "row_cumsum": lambda x: torch.cumsum(x, -1)}
    model_of = {"row_sum": row_sum_order, "row_cumsum": row_cumsum_order}
    records = []
    for site, (fn, args, kw) in sorted(pe["row_inputs"].items()):
        name = fn.__name__
        got, ref = fn(*args, **kw), plain_of[name](*args, **kw)
        model = model_of[name](*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, model), f"{site}: the kernel equals its order model bit for bit "
              f"(max diff {float((got.double() - model.double()).abs().max()):.3e})")
        err = float((got.double() - ref.double()).abs().max())
        u = 2.0**-53 if got.dtype == torch.float64 else 2.0**-24
        if name == "row_cumsum":
            x = args[0].double()
            exact = torch.cumsum(x, -1)
            terms = torch.arange(1, x.shape[-1] + 1, dtype=torch.float64, device=x.device)
            bound = 2.0 * terms * u * torch.cumsum(x.abs(), -1)
            worst = float(((got.double() - exact).abs() / bound.clamp_min(1e-300)).max())
            check(bool(torch.isfinite(got).all()) and worst <= 1.0,
                  f"{site}: each element vs the float64 running sum within 2 (j + 1) u "
                  f"sum|x| (worst {worst:.3e} of its bound)")
            held = f"vs float64 per element {worst:.3e} of 2 (j + 1) u sum|x|"
        else:
            scale = float(plain_of[name](*(t.abs() for t in args), **kw).double().max())
            tol = 2.0 * args[0].shape[-1] * u
            check(bool(torch.isfinite(got).all()) and err <= tol * scale,
                  f"{site}: kernel vs plain {err:.3e} <= {tol:.2e} x {scale:.3e}")
            held = f"/ max sum|terms| {err / scale:.3e} <= 2 n u = {tol:.2e}"
        # in turns (kernel, plain, library, kernel), 200 calls each: at the
        # small sites a call is a few microseconds of host time
        ms_a = time_ms(lambda: fn(*args, **kw), 200, torch)
        plain_ms = time_ms(lambda: plain_of[name](*args, **kw), 200, torch)
        library_ms = time_ms(lambda: plain_of[name](*args, **kw), 200, torch)
        ms_b = time_ms(lambda: fn(*args, **kw), 200, torch)
        ms = (ms_a + ms_b) / 2
        dev_ms = device_ms(lambda: fn(*args, **kw), 20, torch)
        library_dev_ms = device_ms(lambda: plain_of[name](*args, **kw), 20, torch)
        host_bound = dev_ms is not None and ms > 2.0 * dev_ms
        # the host's share: the wrapper, the library call, the wrapper's one
        # output allocation (a queue of long kernels caps these at the device rate)
        shape = args[0].shape if name == "row_cumsum" else args[0].shape[:-1]
        host = [host_us(f, 200, torch) for f in (lambda: fn(*args, **kw),
                                                  lambda: plain_of[name](*args, **kw),
                                                  lambda: args[0].new_empty(shape))]
        n_bytes = sum(t.numel() * t.element_size() for t in args) + got.numel() * got.element_size()
        ops = float(args[0].numel())
        peak = F64_OPS_PER_S if got.dtype == torch.float64 else F32_OPS_PER_S
        bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
        shapes = " @ ".join(str(tuple(t.shape)) for t in args)
        print(f"[kernel] {site} on [pe]'s inputs {shapes} {args[0].dtype}: equal to its order "
              f"model bit for bit; max|kernel-plain|={err:.3e} ({held}); kernel {ms:.4f} ms "
              f"({ms_a:.4f} / {ms_b:.4f}; device {fmt(dev_ms)}), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
              f"(device {fmt(library_dev_ms)}), bound {bound_ms:.4f} ms by {bound_by} -> "
              f"{100 * bound_ms / ms:.1f} % of bound by events"
              + (f", {100 * bound_ms / dev_ms:.1f} % by device time" if dev_ms else "")
              + f"; {pe['row_launches'][site]} launches from this call site in the [pe] run; "
              f"on {card}", flush=True)
        if host_bound:
            print(f"[kernel] {site}: host-bound: the events read {ms:.4f} ms a call against "
                  f"{dev_ms:.4f} ms of device time, so the launch path sets the rate; host "
                  f"time per call: the wrapper {host[0]:.2f} us (its output allocation "
                  f"{host[2]:.2f} us), the library call {host[1]:.2f} us", flush=True)
        records.append({
            "name": site, "route": "cuda", "source": ROW_SOURCE, "replaces": None,
            "launches": pe["row_launches"][site], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            "host_bound": host_bound, "host_us": host[0], "library_host_us": host[1],
            "alloc_host_us": host[2], "model_equal": True, "tables": "pe",
            "why": "fixed-order reduction: a walker's result independent of its batch",
        })
    return records


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude, flux, inspiral
    from emri_frequencydomainwaveforms_tpu_torch.models import modeselect, summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models import waveform as wf
    from emri_frequencydomainwaveforms_tpu_torch.ops import cubic_spline, cuda_build, fd_dense
    from emri_frequencydomainwaveforms_tpu_torch.testing import fd_dense_cases as cases
    from emri_frequencydomainwaveforms_tpu_torch.utils import fdutils
    from emri_frequencydomainwaveforms_tpu_torch.utils.ylm import spin_weighted_ylm

    dev = torch.device("cuda", 0)
    # float32 matmuls (the amplitude projection) in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device ----
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase_done("device")
    # ---- phase 2: build ----
    t0 = time.perf_counter()
    built = cuda_build.build_all()  # one nvcc per source, all at once
    for source, (lib_path, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] csrc/{source}.cu -> {os.path.basename(lib_path)}; ptxas: "
              f"{' | '.join(regs) or log.strip()[:200]}", flush=True)
    print(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s", flush=True)

    phase_done("build")
    # ---- phase 3: kernel vs plain version on the card ----
    # synthetic tables at the main path's shapes (16 main slots of 256 runs,
    # 2 extra slots of 64 runs, r = 64, B = 128)
    nf_syn, r_syn = 1_577_907, BINS_PER_RUN
    groups = on_device(fd_dense, cases.random_groups(
        np.random.default_rng(3), BATCH, [(K_MAX, BAND_RUNS), (TURNOVER_SLOTS, EXTRA_BAND_RUNS)],
        r_syn, nf_syn), dev)
    err_syn, scale = compare(torch, fd_dense, cases, groups, r_syn, nf_syn, "synthetic B=128")
    check(scale > 0, "synthetic tables produce output")
    syn_ms = time_ms(lambda: fd_dense.fd_dense_accumulate(groups, r=r_syn, nf=nf_syn), 10, torch)
    syn_plain_ms = time_ms(
        lambda: fd_dense.fd_dense_accumulate_reference(groups, r=r_syn, nf=nf_syn), 2, torch)
    # every slot dead: the kernel's skeleton (slot lists + zero stores)
    dead = [g._replace(i_lo=torch.full_like(g.i_lo, cases.DEAD)) for g in groups]
    check(not bool(fd_dense.fd_dense_accumulate(dead, r=r_syn, nf=nf_syn).any()),
          "all slots dead: exactly 0")
    skeleton_ms = time_ms(lambda: fd_dense.fd_dense_accumulate(dead, r=r_syn, nf=nf_syn), 10, torch)
    del groups, dead
    torch.cuda.empty_cache()
    print(f"[kernel] synthetic B={BATCH} slots={K_MAX}x{BAND_RUNS}+{TURNOVER_SLOTS}x"
          f"{EXTRA_BAND_RUNS} runs r={r_syn} nf={nf_syn}: max|kernel-plain|={err_syn:.3e} "
          f"(rel {err_syn / scale:.3e} <= 1e-5); kernel {syn_ms:.3f} ms, plain {syn_plain_ms:.3f} ms, "
          f"all slots dead (skeleton) {skeleton_ms:.3f} ms on {card}", flush=True)
    worst = 0.0
    for case in cases.adversarial_cases(np.random.default_rng(45)):
        err, scale = compare(torch, fd_dense, cases, on_device(fd_dense, case.groups, dev),
                             case.r, case.nf, case.name)
        check((case.name == "all_dead") == (scale == 0), f"{case.name}: output scale {scale}")
        worst = max(worst, err / scale if scale else err)
    print(f"[kernel] adversarial layouts (r in 1,3,8,64,128; ragged nf; windows across and "
          f"past nf; 2-bin bands; NaN in masked lanes; 1 and 2 groups; all dead): worst "
          f"max|kernel-plain|/scale {worst:.3e} <= 1e-5, exactly 0 outside every kept band",
          flush=True)

    phase_done("kernel vs plain")
    # ---- phase 4: the flat-physics path at full width ----
    table = amplitude.default_mode_table(30)
    freq = wf.default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    nf = len(f_np)
    f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
    rng = np.random.default_rng(7)  # the reference benchmark's walker jitter
    p0s = 12.0 + 0.12 * (rng.random(BATCH) - 0.5)
    e0s = 0.35 + 0.03 * (rng.random(BATCH) - 0.5)
    ths = 0.7 + 0.2 * (rng.random(BATCH) - 0.5)
    phs = 0.5 + 0.2 * (rng.random(BATCH) - 0.5)
    batch = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (p0s, e0s, ths, phs)]
    env = dict(torch=torch, dev=dev, card=card, wf=wf, fd_dense=fd_dense,
               summation_fd=summation_fd, inspiral=inspiral, amplitude=amplitude,
               cubic_spline=cubic_spline, table=table, batch=batch, nf=nf, f0u=f0u, dfu=dfu,
               cases=cases)
    flat = drive_path("flat", {}, env)
    check(flat["max_knots"] <= MAX_STEPS - 4, f"flat max_knots {flat['max_knots']} <= {MAX_STEPS - 4}")
    flat = {k: flat[k] for k in ("launches", "launches_1", "tables", "tables_1")}
    torch.cuda.empty_cache()

    phase_done("flat path")
    # ---- phase 5: the production flux grid, built on the card ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = flux.default_flux_grid(True, True, True)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    check(grid.values.device == dev and tuple(grid.values.shape) == (96, 49, 2),
          f"flux grid {tuple(grid.values.shape)} on {grid.values.device}")
    check(bool(torch.isfinite(grid.values).all()), "flux grid finite")
    check(bool((grid.values < 0).all()), "every Edot and Ldot of the grid negative")
    check(flux.default_flux_grid(True, True, True) is grid, "flux grid cached per rung and device")
    edot = grid.values[..., 0].abs()
    print(f"[grid] default_flux_grid(tail, factorized, rwz) (96, 49, 2) on {grid.values.device} "
          f"in {grid_s:.2f} s: |Edot| min {float(edot.min()):.4e} max {float(edot.max()):.4e}, "
          f"finite, all fluxes negative; on {card}", flush=True)

    phase_done("flux grid")
    # ---- phase 6: the production (rwz) path at full width ----
    rwz = drive_path("rwz", RWZ, env)
    gen, table_k, forced_idx = rwz["gen"], rwz["table_k"], rwz["forced_idx"]

    # gate 0: the trajectory step budget covers every lane
    check(rwz["max_knots"] <= MAX_STEPS - 4, f"rwz max_knots {rwz['max_knots']} <= {MAX_STEPS - 4}")
    print(f"[gate0] max knots over the {BATCH}-walker rwz batch {rwz['max_knots']} <= "
          f"{MAX_STEPS - 4}", flush=True)

    # gate 1b: the frozen mode set carries every lane's eps power, scored
    # against the full candidate table along each lane's own trajectory
    traj = rwz["traj"]
    amp_kw = {k: v for k, v in RWZ.items() if k != "flux"}
    frozen = wf.FrozenSelection(forced_idx, gen.band_offsets.cpu().numpy(), BINS_PER_RUN, BAND_RUNS)
    t0 = time.perf_counter()
    cov = []
    for lo in range(0, BATCH, COVERAGE_CHUNK):
        lanes = slice(lo, lo + COVERAGE_CHUNK)
        a_re, a_im = amplitude.mode_amplitudes(traj.p[lanes], traj.e[lanes], table, **amp_kw)
        yp = spin_weighted_ylm(table.ls, table.ms, batch[2][lanes], batch[3][lanes])
        ym = spin_weighted_ylm(table.ls, -table.ms, batch[2][lanes], batch[3][lanes])
        live = (torch.arange(traj.t.shape[1], device=dev)[None, :] < traj.n[lanes, None]).to(a_re.dtype)
        power = modeselect.mode_power(a_re, a_im, *yp, *ym, dt_weights=live)
        cov.append(wf.coverage_of(frozen, power))
        del a_re, a_im, power
    cov = torch.cat(cov)
    torch.cuda.synchronize()
    cov_min = float(cov.min())
    check(cov.shape == (BATCH,) and bool(torch.isfinite(cov).all()), "coverage finite per lane")
    check(cov_min >= 1.0 - 1.25 * EPS, f"min coverage {cov_min:.6f} >= {1.0 - 1.25 * EPS}")
    print(f"[gate1b] min mode-power coverage of the frozen {len(forced_idx)} slots over the batch "
          f"{cov_min:.6f} >= {1.0 - 1.25 * EPS} (full {table.num_modes}-mode table, "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    del traj, cov
    torch.cuda.empty_cache()

    # gate 1: banded kernel vs the general sorted-grid kernel, lane 0
    lane0 = [x[:1] for x in batch]
    pro_l0 = wf.waveform_prologue(
        1e6, 10.0, *lane0, 1.0, 0.0, 0.0, t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS,
        max_steps=MAX_STEPS, forced_idx=np.arange(len(forced_idx)), **RWZ,
    )
    sub = np.arange(0, nf, 617)
    # full-window banded evaluation: the same kernel with the band windows
    # off, which separates kernel correctness from the window budget
    fw_tables = []
    with dense_function(summation_fd, capturing(fd_dense.fd_dense_accumulate, fw_tables)):
        banded_fw = wf.fd_waveform_core(
            pro_l0, table_k, nf, channels=True, uniform=(f0u, dfu), bins_per_run=BINS_PER_RUN,
            turnover_slots=TURNOVER_SLOTS,
        )
    # whole-grid windows are a shape the production path never gives the kernel
    fw_err, fw_scale = compare(torch, fd_dense, cases, *fw_tables[0], "full-window tables")
    general = wf.fd_waveform_core(
        pro_l0, table_k, torch.as_tensor(f_np[sub], device=dev), channels=True,
        turnover_slots=TURNOVER_SLOTS,
    )
    check(all(bool(torch.isfinite(o).all()) for o in (*banded_fw, *general)), "gate 1 outputs finite")
    is_edge = band_edge_mask(wf, pro_l0, table_k, f_np[sub], dfu)
    x_non, x_edge, x_full = split_rel_l2(banded_fw, general, sub, is_edge)
    # window truncation: the production windows (the B = 1 run above) against
    # the full-window evaluation, what the frozen 256-run budget drops
    _, _, werr = split_rel_l2(rwz["single"], [w[:, sub] for w in banded_fw], sub,
                              np.zeros(len(sub), dtype=bool))
    print(f"[gate1] banded full-window vs general on {len(sub)} bins (lane 0, rwz): rel L2 "
          f"{x_non:.4e} off the band edges (< 1e-3), {x_edge:.4e} on {int(is_edge.sum())} edge "
          f"bins (< 0.05), {x_full:.4e} over all; window truncation (production windows vs "
          f"full window) {werr:.4e} (< 1e-3); kernel vs plain on the full-window tables "
          f"({fw_tables[0][0][0].pc.shape[2]} runs per slot) rel {fw_err / fw_scale:.3e}", flush=True)
    check(x_non < 1e-3 and x_edge < 0.05, f"kernel cross-check {x_non:.3e} / edges {x_edge:.3e}")
    check(werr < 1e-3, f"window truncation {werr:.3e} < 1e-3")
    del banded_fw, general

    # gate 2: FD/TD Hann mismatch at the full 1-yr configuration, lane 0:
    # the production-window banded spectrum (the B = 1 run above) against
    # the dense TD sum, both windowed, as bench.py computes it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp_td, hc_td = (h[0].cpu().numpy() for h in
                    wf.td_waveform_core(pro_l0, table_k, wf.default_time_grid(T_YEARS, DT)))
    torch.cuda.synchronize()
    td_s = time.perf_counter() - t0
    single = [o[0].double().cpu().numpy() for o in rwz["single"]]
    hp_fd, hc_fd = wf._assemble_channels(freq, single[0] + 1j * single[1],
                                         single[2] + 1j * single[3], True)
    w_hann = np.hanning(len(hp_td))
    fd_w = fdutils.get_fd_windowed([hp_fd, hc_fd], w_hann)
    td_w = fdutils.get_fft_td_windowed([hp_td, hc_td], w_hann, DT)
    pos = freq >= 0
    mm_hp, mm_hc = (mismatch(a[pos], b[pos]) for a, b in zip(fd_w, td_w))
    check(np.isfinite(hp_td).all() and np.isfinite(hc_td).all(), "gate 2 TD waveform finite")
    print(f"[gate2] FD/TD Hann mismatch, lane 0 (rwz, 1 yr, {len(hp_td)} samples): h+ "
          f"{mm_hp:.4e}, hx {mm_hc:.4e} (< 1e-4); the TPU's record {GATE2_TPU[0]:.3e} / "
          f"{GATE2_TPU[1]:.4e} (BENCH_r04.json, TPU); TD sum on the card {td_s:.2f} s, "
          f"{time.perf_counter() - t0:.2f} s with the host windowing; on {card}", flush=True)
    check(mm_hp < 1e-4 and mm_hc < 1e-4, f"gate 2 mismatch {mm_hp:.3e} / {mm_hc:.3e} < 1e-4")
    del hp_td, hc_td, hp_fd, hc_fd, fd_w, td_w, single

    # gate 1c: a plunging source through the banded path with the turnover
    # slots, against the general kernel
    pro_pl = wf.waveform_prologue(
        *PLUNGING, t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS, **RWZ
    )
    sub_pl = np.arange(0, nf, 1043)
    banded_pl = wf.fd_waveform_core(
        pro_pl, table, nf, channels=True, uniform=(f0u, dfu), bins_per_run=BINS_PER_RUN,
        turnover_slots=TURNOVER_SLOTS, extra_band_runs=None,
    )
    general_pl = wf.fd_waveform_core(
        pro_pl, table, torch.as_tensor(f_np[sub_pl], device=dev), channels=True,
        turnover_slots=TURNOVER_SLOTS,
    )
    is_term = band_edge_mask(wf, pro_pl, table, f_np[sub_pl], dfu)
    pl_non, pl_term, _ = split_rel_l2(banded_pl, general_pl, sub_pl, is_term)
    t_plunge = float(pro_pl.t_end[0]) / 31558149.763545603
    print(f"[gate1c] plunging source (ends at {t_plunge:.4f} yr, {int(pro_pl.n_live[0])} knots) "
          f"banded vs general on {len(sub_pl)} bins: rel L2 {pl_non:.4e} off the terminations "
          f"(< 1e-3), {pl_term:.4e} on {int(is_term.sum())} termination bins (< 0.3)", flush=True)
    check(np.isfinite(pl_non) and pl_non < 1e-3, f"plunge cross-check {pl_non:.3e} < 1e-3")
    check(np.isfinite(pl_term) and pl_term < 0.3, f"plunge terminations {pl_term:.3e} < 0.3")
    del banded_pl, general_pl, pro_pl, pro_l0
    torch.cuda.empty_cache()

    phase_done("rwz path and gates 0, 1b, 1, 1c, 2")
    # ---- the data-driven amplitude backends, on the rwz batch's knots ----
    drive_backends(env, rwz)
    torch.cuda.empty_cache()

    phase_done("backends")
    # ---- the reference's Pallas-named FD entry points at full width ----
    pallas = drive_pallas_names(env, rwz)
    torch.cuda.empty_cache()

    phase_done("pallas-names")
    # ---- the production batch through the quadrature trajectory ----
    quad = drive_quad(env, rwz)
    rwz = {k: rwz[k] for k in ("launches", "launches_1", "tables", "tables_1")}
    del gen
    torch.cuda.empty_cache()

    phase_done("quad")
    # ---- the TD-vs-FD scan, cli/check_mode_by_mode.py, one draw at 1 yr ----
    scan = drive_scan(env)
    torch.cuda.empty_cache()

    phase_done("scan")
    # ---- the run matrix's paper-source rows at full size, in a process of
    # its own from here to the kernel records: its duration solve beside
    # [facades] and [pe], its rows after [pe] ----
    matrix_child = start_matrix(env)
    # ---- the reference-signature facades ----
    drive_facades(env)

    phase_done("facades")
    # ---- phase 7: parameter estimation, cli/emri_pe.py at the production settings ----
    pe = drive_pe(env)
    torch.cuda.empty_cache()

    phase_done("pe")
    tell_child(matrix_child, "rows")
    # ---- the Fisher set on the PE template, relative binning, the sampler diagnostics ----
    fisher = drive_fisher(env, pe)
    # from here on [matrix]'s rows share the card: each phase returns its cache
    torch.cuda.empty_cache()
    phase_done("fisher")
    drive_relbin(env)
    phase_done("relbin")
    drive_diagnostics(env, pe)
    phase_done("diagnostics")
    # ---- the move library and its schedule, the TDI / MLDC layer, on the PE likelihood ----
    # with the port's examples beside it, each in a process of its own
    def moves_phase():
        out = drive_moves(env, pe, fisher)
        torch.cuda.empty_cache()
        phase_done("moves")
        return out

    tools_child = start_tools(env, pe)
    moves = drive_examples(env, moves_phase)
    phase_done("examples")
    tools = finish_tools(env, tools_child)
    phase_done("tools")
    rj = drive_rj(env, pe, moves)
    torch.cuda.empty_cache()
    phase_done("rj")
    # ---- walker and frequency sharding on torch.distributed, the dry run ----
    mesh = drive_mesh(env, grid)
    phase_done("mesh")
    drive_tdi(env, pe, fisher)
    del pe["out"], fisher
    torch.cuda.empty_cache()

    phase_done("tdi")
    # ---- the reference's independent truths ----
    truth = drive_truth(env)
    torch.cuda.empty_cache()
    phase_done("truth")
    matrix = finish_matrix(matrix_child)
    phase_done("matrix (waited for, and its kernel records)")
    # ---- phase 8: the kernel on the main paths' own tables ----
    records = []
    for (groups, r, nf_t), name, pallas_line, n_launched, reps in (
        (flat["tables"], "fd_dense_accumulate_batched", 203, flat["launches"], 10),
        (flat["tables_1"], "fd_dense_accumulate", 99, flat["launches_1"], 100),
        (rwz["tables"], "fd_dense_accumulate_batched[rwz]", 203, rwz["launches"], 10),
        (rwz["tables_1"], "fd_dense_accumulate[rwz]", 99, rwz["launches_1"], 100),
        (pe["tables"], "fd_dense_accumulate_batched[pe]", 203, pe["launches"], 10),
        (pe["tables_1"], "fd_dense_accumulate[pe]", 99, pe["launches_1"], 100),
        (moves["tables"], "fd_dense_accumulate_batched[moves]", 203, moves["launches"], 10),
        (rj["tables"], "fd_dense_accumulate_batched[rj]", 203, rj["launches"], 10),
        (mesh["tables"], "fd_dense_accumulate_batched[mesh]", 203, mesh["launches"], 10),
        (quad["tables"], "fd_dense_accumulate_batched[quad]", 203, quad["launches"], 10),
        (scan["tables"], "fd_dense_accumulate[scan]", 99, scan["launches"], 10),
        (pallas["tables"], "fd_dense_accumulate_batched[pallas-names]", 203, pallas["launches"], 10),
        (pallas["tables_1"], "fd_dense_accumulate[pallas-names]", 99, pallas["launches_1"], 100),
        (truth["tables_fold"], "fd_dense_accumulate[truth-fold]", 99, truth["launches_fold"], 100),
        (truth["tables_plunge"], "fd_dense_accumulate[truth-plunge]", 99,
         truth["launches_plunge"], 100),
        *((tools["tables"][f"r{r}"], f"fd_dense_accumulate[tools-r{r}]", 99,
           tools["launches"][f"r{r}"], 100) for r in TOOLS_RECORD_RUNS),
    ):
        records.append(dense_record(env, groups, r, nf_t, name, pallas_line, n_launched, reps))
        if groups[0].pc.shape[0] == BATCH:
            records[-1]["skeleton_ms"] = skeleton_ms
        if name.endswith("[mesh]"):
            records[-1]["launches_per_rank"] = mesh["per_rank"]
        torch.cuda.empty_cache()
    records += matrix["records"]
    records += row_records(torch, card, pe)

    phase_done("kernel records")
    # ---- what the quad trajectory issues to the card, traced last: traced
    # with host activity inside the quad phase (NVIDIA H100 80GB HBM3, 700 W),
    # the quad and dp5 trajectories' ~3 x 10^5 launches took minutes to stop,
    # the phases after ran slower and phase 8's profiler read no device time ----
    kernels, copies, busy_ms, traced_ms = device_trace(quad["run_quad"], torch)
    check(kernels > 0, "[timing quad] the traced quad trajectory launched kernels")
    print(f"[timing quad] quad trajectory ({BATCH} walkers, rwz), one run traced by "
          f"torch.profiler: {kernels} kernel launches, {copies} copies and fills, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / kernels * 1e3:.2f} us per launch; "
          f"{100 * busy_ms / quad['quad_ms']:.1f} % of the untraced {quad['quad_ms']:.1f} ms "
          f"mean); {traced_ms:.1f} ms traced, host clock; on {card}", flush=True)
    del quad
    phase_done("quad trace")
    print(f"[seconds] whole script {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
