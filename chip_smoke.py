#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernel from the sources in this checkout,
checks it against its plain PyTorch version on the card at the main path's
shapes, then drives the port's main path once at full width: a 128-walker
batch of all-mode FD waveforms of a 1-yr source at dt = 10 s (1,577,907
positive bins), eps = 1e-2 selection frozen to 16 slots, 256-run windows of
64 bins and 2 turnover slots, with the flat physics (Peters-Mathews flux,
plain multipole amplitudes). Every phase raises on failure.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (``/usr/local/cuda``); imports no JAX. The
next-to-last line of output is the kernel record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
KERNEL_REPLACES = "emri_frequencydomainwaveforms_tpu/ops/pallas/fd_dense.py:203"


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


def synthetic_groups(torch, dense, rng, dev):
    """Dense-pass tables at the main path's shapes (16 main slots of 256
    runs, 2 extra slots of 64 runs, r = 64): overlapping windows, a dead
    slot, band edges inside runs and NaN coefficients in masked lanes."""
    nf, r = 1_577_907, BINS_PER_RUN
    g_total = -(-nf // r)
    groups = []
    for n_s, g_band in ((K_MAX, BAND_RUNS), (TURNOVER_SLOTS, EXTRA_BAND_RUNS)):
        shape = (BATCH, n_s, g_band)
        pc = rng.uniform(-3.0, 3.0, shape + (4,)).astype(np.float32)
        nc = rng.integers(-4000, 4000, shape + (3,)).astype(np.int32)
        ec = rng.uniform(-1.0, 1.0, shape + (8,)).astype(np.float32)
        g0 = rng.integers(0, g_total, (BATCH, n_s)).astype(np.int32)
        g0[:, 1] = g0[:, 0] + g_band // 3  # overlapping windows
        i_lo = rng.integers(r, g_band * r // 4, (BATCH, n_s)).astype(np.int32) + 7
        i_hi = (i_lo + rng.integers(r, g_band * r, (BATCH, n_s))).astype(np.int32)
        i_lo[:, -1] = 2**31 - 1  # dead slot
        pc[:, :, 0, 1] = np.nan  # run 0 lies below every i_lo: masked lanes
        ec[:, :, 0, 4] = np.nan
        w = rng.standard_normal((BATCH, n_s, 4)).astype(np.float32)
        groups.append(dense.DenseGroup(
            *(torch.from_numpy(x).to(dev) for x in (pc, nc, ec, i_lo, i_hi, w, g0))
        ))
    return groups, nf, r


@contextlib.contextmanager
def dense_function(summation_fd, fn):
    """Route the FD core's dense pass through ``fn`` for the duration."""
    saved = summation_fd.fd_dense_accumulate
    summation_fd.fd_dense_accumulate = fn
    try:
        yield
    finally:
        summation_fd.fd_dense_accumulate = saved


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import (
        default_mode_table,
        mode_amplitudes,
    )
    from emri_frequencydomainwaveforms_tpu_torch.models.inspiral import (
        schwarz_ecc_flux_inspiral,
    )
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import (
        FrozenFDWaveform,
        band_offsets_for,
        default_frequencies,
        fd_waveform_core,
        waveform_prologue,
    )
    from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense

    dev = torch.device("cuda", 0)
    # float32 matmuls (the amplitude projection) in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device ----
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    lib_path, log = fd_dense.build_kernel()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] {KERNEL_SOURCE} -> {os.path.basename(lib_path)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs) or log.strip()[:200]}",
          flush=True)

    # ---- phase 3: kernel vs plain version on the card ----
    rng = np.random.default_rng(3)
    groups, nf_syn, r_syn = synthetic_groups(torch, fd_dense, rng, dev)
    out_k = fd_dense.fd_dense_accumulate(groups, r=r_syn, nf=nf_syn)
    out_p = fd_dense.fd_dense_accumulate_reference(groups, r=r_syn, nf=nf_syn)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "kernel output finite")
    max_abs_err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    check(scale > 0, "synthetic tables produce output")
    check(max_abs_err / scale <= 1e-5, f"kernel vs plain {max_abs_err / scale:.3e} <= 1e-5")
    del out_k, out_p
    kernel_ms = time_ms(lambda: fd_dense.fd_dense_accumulate(groups, r=r_syn, nf=nf_syn), 20, torch)
    plain_ms = time_ms(lambda: fd_dense.fd_dense_accumulate_reference(groups, r=r_syn, nf=nf_syn), 3, torch)
    del groups
    torch.cuda.empty_cache()
    print(f"[kernel] fd_dense_accumulate B={BATCH} slots={K_MAX}x{BAND_RUNS}+{TURNOVER_SLOTS}x"
          f"{EXTRA_BAND_RUNS} runs r={r_syn} nf={nf_syn}: max|kernel-plain|={max_abs_err:.3e} "
          f"(rel {max_abs_err / scale:.3e} <= 1e-5); kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms on {card}", flush=True)

    # ---- phase 4: the slice at full width ----
    table = default_mode_table(30)
    freq = default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    nf = len(f_np)
    f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
    src = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)
    pro_sel = waveform_prologue(
        *src, t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS, device=dev
    )
    forced_idx = pro_sel.sel.idx[0].cpu().numpy()
    table_k = table.take(forced_idx)
    idx_k = np.arange(len(forced_idx))
    pro0 = waveform_prologue(
        *src, t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS, max_steps=MAX_STEPS,
        forced_idx=idx_k, device=dev,
    )
    offsets = band_offsets_for(pro0, table_k, f0u, dfu, BINS_PER_RUN, BAND_RUNS)
    gen = FrozenFDWaveform(
        table_k, offsets, f0=f0u, df=dfu, nf=nf, t_years=T_YEARS, mass_1=1e6, mass_2=10.0,
        max_steps=MAX_STEPS, bins_per_run=BINS_PER_RUN, band_runs=BAND_RUNS,
        turnover_slots=TURNOVER_SLOTS, extra_band_runs=EXTRA_BAND_RUNS,
    ).to(dev)

    rng = np.random.default_rng(7)  # the reference benchmark's walker jitter
    p0s = 12.0 + 0.12 * (rng.random(BATCH) - 0.5)
    e0s = 0.35 + 0.03 * (rng.random(BATCH) - 0.5)
    ths = 0.7 + 0.2 * (rng.random(BATCH) - 0.5)
    phs = 0.5 + 0.2 * (rng.random(BATCH) - 0.5)
    batch = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (p0s, e0s, ths, phs)]

    fd_dense.fd_dense_accumulate.launches = 0
    out = gen(*batch)
    torch.cuda.synchronize()
    launches = fd_dense.fd_dense_accumulate.launches
    check(launches > 0, "the main path launched the fd_dense kernel")
    check(all(o.shape == (BATCH, nf) and o.dtype == torch.float32 for o in out), "output shapes")
    check(all(bool(torch.isfinite(o).all()) for o in out), "all outputs finite")
    hp_abs = torch.hypot(out[0], out[1])
    nonzero = int((hp_abs > 0).sum(dim=1).min())
    peak = float(hp_abs.max())
    check(nonzero > 0, "every lane has nonzero bins")
    # |h~| ~ |A| / sqrt(fdot) at 1 Gpc for mu = 10 Msun: ~1e-18 1/Hz
    check(1e-21 < peak < 1e-15, f"peak |h+~| {peak:.3e} physically sane")
    traj = schwarz_ecc_flux_inspiral(
        1e6, 10.0, batch[0], batch[1], t_years=T_YEARS, max_steps=MAX_STEPS
    )
    max_knots = int(traj.n.max())
    check(max_knots <= MAX_STEPS - 4, f"max_knots {max_knots} <= {MAX_STEPS - 4}")

    # lane 0 against its twin through the plain dense pass, on the card
    with dense_function(summation_fd, fd_dense.fd_dense_accumulate_reference):
        twin = gen(*(x[:1] for x in batch))
    rel_l2 = max(
        float(torch.linalg.vector_norm(o[0].double() - t[0].double())
              / torch.linalg.vector_norm(t[0].double()))
        for o, t in zip(out, twin)
    )
    check(rel_l2 <= 1e-5, f"lane 0 vs plain-dense twin rel L2 {rel_l2:.3e} <= 1e-5")
    # lane 0 against the same module on the CPU (plain paths throughout)
    cpu = gen.to("cpu")
    host = cpu(*(x[:1].cpu() for x in batch))
    gen.to(dev)
    rel_cpu = max(
        float(torch.linalg.vector_norm(o[0].cpu().double() - h[0].double())
              / torch.linalg.vector_norm(h[0].double()))
        for o, h in zip(out, host)
    )
    print(f"[slice] B={BATCH} nf={nf} slots={len(forced_idx)}+{TURNOVER_SLOTS}: finite, "
          f"fd_dense launches={launches}, min nonzero bins/lane={nonzero}, peak |h+~|={peak:.4e}, "
          f"max_knots={max_knots}, lane0 vs plain-dense twin rel L2={rel_l2:.3e}, "
          f"lane0 vs CPU port rel L2={rel_cpu:.3e}", flush=True)
    check(rel_cpu <= 1e-4, f"lane 0 GPU vs CPU rel L2 {rel_cpu:.3e} <= 1e-4")

    # ---- timing (informational) ----
    del out, twin, host, hp_abs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        gen(*batch)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / 3
    stage = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = schwarz_ecc_flux_inspiral(1e6, 10.0, batch[0], batch[1], t_years=T_YEARS,
                                     max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    stage["trajectory"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mode_amplitudes(traj.p, traj.e, table_k, family_c=gen.family_c)
    torch.cuda.synchronize()
    stage["amplitudes"] = time.perf_counter() - t0
    pro = waveform_prologue(
        1e6, 10.0, *batch, 1.0, 0.0, 0.0, t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS,
        max_steps=MAX_STEPS, forced_idx=idx_k, family_c=gen.family_c,
    )
    dense_s = []

    def timed_dense(groups_, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fd_dense.fd_dense_accumulate(groups_, **kw)
        torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t1)
        return res

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dense_function(summation_fd, timed_dense):
        fd_waveform_core(
            pro, table_k, nf, channels=True, uniform=(f0u, dfu), band_runs=BAND_RUNS,
            band_offsets=gen.band_offsets, bins_per_run=BINS_PER_RUN,
            turnover_slots=TURNOVER_SLOTS, extra_band_runs=EXTRA_BAND_RUNS,
            band_offsets_extra=gen.band_offsets_extra, out_f32=True,
        )
    torch.cuda.synchronize()
    stage["dense pass"] = dense_s[0]
    stage["splines + level-1"] = time.perf_counter() - t0 - dense_s[0]
    print(f"[timing] {BATCH / per_batch:.2f} waveforms/s ({per_batch * 1e3:.1f} ms per "
          f"{BATCH}-walker batch, host clock, synchronized); stages (ms): "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stage.items())
          + f"; on {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fd_dense_accumulate",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
