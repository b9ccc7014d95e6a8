"""Run one cell of ``BENCHMARK.json``, driven by its data.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything is found by name, so that a new configuration, traffic mix,
metric or cell is a new file and a new entry, with no edit here:

- the configuration: the ``file`` its entry in ``configs`` gives;
- the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver``
  key names the general driver ``benchmark/drivers/<driver>.py`` that reads
  it (its ``setup``, ``window`` and ``compare``);
- the cell's limits: ``benchmark/cells/<workload>.json`` (``checks``:
  {number: limit}; a number passes at or below its limit);
- a metric: ``benchmark/metrics/<name>.py``, else the reader of its name up
  to the first dot (``trajectory_dp5_ms.pe`` -> ``trajectory_dp5_ms.py``): a
  ``read(run)`` that returns the value, or None where it finds nothing.

The run: set-up (printed split by stage), the window of whole steps for
``seconds``, then (traced) the per-layer readings, then the program's state
freed and the reference's comparison. The last line of standard output is
the result; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import torch

from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "emri_frequencydomainwaveforms_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of a benchmark spec, resolved to its files."""

    def __init__(self, name: str, root: str = ROOT, spec_path: str | None = None):
        self.root = root
        self.spec = load_json(spec_path or os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, by_name[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[self.workload["config"]]
        self.cfg = load_json(os.path.join(root, conf["file"]))
        bench = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(bench, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench, "cells", name + ".json"))["checks"]
        self.driver = importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")
        self.metrics_dir = os.path.join(bench, "metrics")

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or (traced) its per-layer ones."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, name: str):
        for stem in (name, name.split(".")[0]):
            path = os.path.join(self.metrics_dir, stem + ".py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for metric {name!r} in {self.metrics_dir}")


class Context:
    """What a driver is handed: the cell's data, the run's settings, and the
    recorders of set-up stages, spans and roofline inputs."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.dev = torch.device(device)
        self.setup_split: dict[str, float] = {}
        self.spans = Spans(self.sync)
        self.devtrace = None
        self.profiling = False
        self.units_profiled = 0
        self.bounds: dict[str, list] = {}
        self.harness_bytes = 0  # device memory the harness itself holds through the window

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a set-up stage (synchronized) into ``setup_split``."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.setup_split[name] = time.perf_counter() - t0
        log(f"[setup] {name}: {self.setup_split[name]:.3f} s")


class Run:
    """What the metric readers read."""

    def __init__(self, ctx: Context, win, setup_s: float, peak_window_bytes):
        self.traffic, self.cfg = ctx.traffic, ctx.cfg
        self.driver = ctx.traffic["driver"]
        self.units, self.wall_s, self.walls = win.units, win.wall_s, win.walls
        self.setup_s = setup_s
        # the program's own peak: the harness's buffer of kept outputs left out
        self.peak_window_bytes = (None if peak_window_bytes is None
                                  else peak_window_bytes - ctx.harness_bytes)
        self.spans = ctx.spans if ctx.trace else None
        self.devtrace = ctx.devtrace
        self.bounds = ctx.bounds
        self.units_profiled = ctx.units_profiled


def _counters():
    """The port's launch counters: {name: count so far}."""
    from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense, row_ops

    return {"fd_dense.launches": fd_dense.fd_dense_accumulate.launches,
            "row_sum.launches": row_ops.row_sum.launches,
            "row_cumsum.launches": row_ops.row_cumsum.launches}


def devices_used() -> int:
    """The CUDA devices on which this process allocated memory."""
    return sum(1 for i in range(torch.cuda.device_count())
               if torch.cuda.max_memory_reserved(i) > 0)


def breakdown(run: Run) -> dict | None:
    """The device operations that took most time and the longest idle gaps,
    each gap named by the host span open at its middle."""
    dt = run.devtrace
    if dt is None or not dt.ops:
        return None
    ops = sorted(((n, s) for n, (_, s) in dt.ops.items()), key=lambda x: -x[1])[:10]
    gaps = [[run.spans.innermost((a + b) // 2), (b - a) * 1e-9] for a, b in dt.gaps[:10]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
             faults=None, control: bool = False) -> dict:
    """One run of ``cell``: returns the result object (see the module
    docstring). ``faults`` (tests only): a context manager entered around
    the window, which breaks the timed path underneath. ``control``
    (control.py only): also the control's numbers on the same inputs, under
    the result's key ``control``."""
    ctx = Context(cell, seed, seconds, trace, device)
    cuda = ctx.dev.type == "cuda"
    with ctx.stage("imports / CUDA init"):
        import emri_frequencydomainwaveforms_tpu_torch  # noqa: F401

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cuda:
            torch.cuda.set_device(ctx.dev)
            torch.zeros(1, device=ctx.dev)
    if cuda:
        with ctx.stage("kernels"):
            from emri_frequencydomainwaveforms_tpu_torch.ops import cuda_build

            for name, (_, build_log) in cuda_build.build_all().items():
                log(f"[setup] csrc/{name}.cu: {build_log.strip().splitlines()[-1][:160]}")
    st = cell.driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    rest = setup_s - sum(ctx.setup_split.values())
    log(f"[setup] setup_s {setup_s:.3f} s (process start to the first timed step), by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_split.items())
        + f", interpreter, torch and the harness {rest:.3f}")
    peak_setup = torch.cuda.max_memory_allocated(ctx.dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.dev)
    before = _counters()
    with faults if faults is not None else contextlib.nullcontext():
        win = cell.driver.window(ctx, st)
    ctx.sync()
    after = _counters()
    peak_window = torch.cuda.max_memory_allocated(ctx.dev) if cuda else None
    counters = {k: after[k] - before[k] for k in after}
    log(f"[window] {len(win.walls)} steps, {win.units} units in {win.wall_s:.3f} s; steps (s): "
        + " ".join(f"{w:.3f}" for w in win.walls))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    if trace:
        from ..drivers import common

        common.finish_bounds(ctx)
        log(f"[trace] counters over the window: {counters}")
        if hasattr(cell.driver, "truncation"):
            worst, value, past, n = cell.driver.truncation(ctx, st, win.kept["first_batch"])
            log(f"[truncation] the first timed batch, configured windows vs whole-band windows: "
                f"worst lane {worst} at {value:.4e}, {past} of {n} lanes past 1e-4 (worst "
                f"channel's relative L2)")
    run = Run(ctx, win, setup_s, peak_window)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = cell.driver.compare(ctx, win.kept)
    log(f"[compare] the reference took {time.perf_counter() - t_ref:.3f} s")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    # a non-finite answer in the window says the wrong thing, whether kept or not
    correct = (all(c["value"] <= c["limit"] for c in checks.values()) and len(checks) > 0
               and win.failed == 0)
    dev = {"platform": "gpu" if cuda else ctx.dev.type,
           "kind": torch.cuda.get_device_name(ctx.dev) if cuda else "cpu",
           "count": devices_used() if cuda else 0,
           "memory_peak_bytes": max(peak_setup, peak_window) if cuda else None,
           "used": str(ctx.dev)}
    result = {"correct": correct, "attempted": win.units, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if trace and run.devtrace is not None and cuda:
        dev["busy_s"], dev["window_s"] = run.devtrace.busy_s, run.devtrace.window_s
        bd = breakdown(run)
        if bd:
            result["breakdown"] = bd
    if control:
        result["control"] = cell.driver.compare(ctx, win.kept, control=True)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    for k, c in checks.items():
        log(f"[check] {k} {c['value']!r} limit {c['limit']!r}")
    return result


__all__ = ["Cell", "Context", "Run", "run_cell", "forbidden_modules"]
