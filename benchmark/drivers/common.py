"""What both drivers share: the window loop, the layer spans of a traced
run, the roofline inputs recorded while the device is profiled, and the
configuration's model data in the program's types."""

from __future__ import annotations

import contextlib
import time

import torch

from ..lib import devtrace, roofline
from ..lib.spans import patched


class Window:
    """What a window produced: whole steps (or batches) with their walls,
    the units they completed, and what the comparison needs."""

    def __init__(self):
        self.walls: list[float] = []
        self.wall_s = 0.0
        self.units = 0
        self.failed = 0
        self.kept: dict = {}


def run_window(ctx, step, units_per_step: int) -> Window:
    """Run ``step(i)`` in whole steps until ``ctx.seconds`` have passed (the
    last step counted, its time included), synchronized after each. A
    traced run first runs one step with the device profiled, outside the
    window's seconds (the profiler slows it and reads its trace after it)."""
    win = Window()
    if ctx.trace:
        ctx.spans.records.clear()
        step = ctx.spans.wrap("step", step)
        with profiling(ctx):
            step(0)
            ctx.sync()
        ctx.units_profiled = units_per_step
        win.units += units_per_step
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        step(len(win.walls) + (1 if ctx.trace else 0))
        ctx.sync()
        t1 = time.perf_counter()
        win.walls.append(t1 - t0)
        win.units += units_per_step
        if t1 - t_start >= ctx.seconds:
            break
    win.wall_s = time.perf_counter() - t_start
    return win


@contextlib.contextmanager
def profiling(ctx):
    """Profile the device over the body (CUDA only) and record, for the
    launches inside it, what the roofline readers need."""
    ctx.devtrace = devtrace.DeviceTrace()
    ctx.profiling = True
    try:
        if ctx.dev.type == "cuda":
            with devtrace.profiled(ctx.devtrace, ctx.sync):
                yield
        else:
            yield
    finally:
        ctx.profiling = False


def layer_spans(ctx, waveform, summation_fd):
    """Spans of a traced run around the calls the prologue and the FD core
    make into each layer, and the dense pass's and the running sum's inputs
    while the device is profiled. Returns an ExitStack (empty untraced)."""
    stack = contextlib.ExitStack()
    if not ctx.trace:
        return stack
    spans = ctx.spans
    fd_dense = summation_fd.fd_dense_accumulate
    cumsum = summation_fd.row_cumsum

    def dense(groups, *, r, nf):
        out = spans.wrap("fd_dense", fd_dense)(groups, r=r, nf=nf)
        if ctx.profiling:
            ctx.bounds.setdefault("fd_dense_tables", []).append((groups, r, nf))
        return out

    def running_sum(x):
        if ctx.profiling:
            ctx.bounds.setdefault("row_cumsum", []).append(roofline.row_cumsum_bound_s(x))
        return cumsum(x)

    name = "trajectory_" + ctx.traffic.get("traj_method", "dp5")
    stack.enter_context(patched(waveform, "schwarz_ecc_flux_inspiral",
                                spans.wrap(name, waveform.schwarz_ecc_flux_inspiral)))
    stack.enter_context(patched(waveform, "mode_amplitudes",
                                spans.wrap("amplitudes", waveform.mode_amplitudes)))
    stack.enter_context(patched(summation_fd, "_level1_walker_chunks",
                                spans.wrap("level1", summation_fd._level1_walker_chunks)))
    stack.enter_context(patched(summation_fd, "fd_dense_accumulate", dense))
    stack.enter_context(patched(summation_fd, "row_cumsum", running_sum))
    return stack


def finish_bounds(ctx) -> None:
    """Turn the dense pass's recorded tables into bounds (after the
    profiled region, so that counting them costs it nothing)."""
    tables = ctx.bounds.pop("fd_dense_tables", [])
    ctx.bounds["fd_dense"] = [roofline.fd_dense_bound_s(g, r, nf) for g, r, nf in tables]


def program_flux_grid(cfg, device):
    """The configuration's flux table as the program's `FluxGrid` on
    ``device``: the model's data, which the reference reads too."""
    from emri_frequencydomainwaveforms_tpu_torch.models.flux import FluxGrid

    from ..reference import plain

    t = plain.flux_table(cfg)
    return FluxGrid(u0=t.u0, du=t.du, e0=t.e0, de=t.de,
                    values=torch.as_tensor(t.values, dtype=torch.float64, device=device))


def program_table(cfg, amplitude):
    """The program's mode table of the configuration's frozen harmonics,
    in the configuration's order."""
    from emri_frequencydomainwaveforms_tpu_torch.models.modeselect import table_indices_for

    table = amplitude.default_mode_table(cfg["n_max"], l_max=cfg["l_max"])
    return table.take(table_indices_for(table, [tuple(h) for h in cfg["harmonics"]]))
