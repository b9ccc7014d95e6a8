"""The canned end-to-end run matrix, on the PyTorch port.

The port's counterpart of ``tools/test_matrix.sh``: the same six runs with
the same flag strings, parsed by the port's own CLI parsers and run in
order through `cli/emri_pe.py::run_emri_pe` and
`cli/check_mode_by_mode.py::run_check`. Five PE runs on the paper source
(M = 3.67e6, mu = 292, e0 = 0.579, Tobs = 4 yr) and the tutorial source
sweep template {td, fd} x injectFD {0, 1} x window_flag {0, 1} x downsample
{0, 2, 100}; the sixth run is a TD-vs-FD scan. ``--quick`` shrinks Tobs,
the grids and the scan as the original's ``QUICK=1`` does.

Each row prints its flags, the solved p0 and the injection's knot count,
nf, the injection SNR, log L at the truth and its seconds (and, on a CUDA
device, its peak device memory). Where h5py imports, each run writes the
CLI's HDF chain or scan file, into a temporary directory removed at the
end; without h5py the PE runs keep their chains in the in-memory backend
and the scan writes no file.

Run on ``cuda:0``, or on the CPU with ``--device cpu``:

    PYTHONPATH=. python tools/torch_test_matrix.py [--quick] [--rows 1,3] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile
import time

import numpy as np

# the original's shell variables (tools/test_matrix.sh:15-19)
SIZES = {
    False: dict(TOBS="4.0", TOBS2="2.0", DS0="0", NSCAN="10"),
    True: dict(TOBS="0.1", TOBS2="0.1", DS0="32", NSCAN="2"),
}
PAPER = ("-M 3670041.7362535275 -mu 292.0583167470244 -e0 0.5794130830706371 -eps 1e-2 "
         "-dt 10.0 -nwalkers 16 -ntemps 1 -nsteps 1")
# (cli, flags) of tools/test_matrix.sh:22-30, the shell variables unexpanded
ROWS = (
    ("pe", "-Tobs $TOBS $PAPER -injectFD 0 -template td -downsample $DS0 -window_flag 1 "
           "--outname /tmp/tm1.h5"),
    ("pe", "-Tobs $TOBS $PAPER -injectFD 1 -template td -downsample $DS0 -window_flag 1 "
           "--outname /tmp/tm2.h5"),
    ("pe", "-Tobs $TOBS $PAPER -injectFD 0 -template fd -downsample $DS0 -window_flag 1 "
           "--outname /tmp/tm3.h5"),
    ("pe", "-Tobs $TOBS $PAPER -injectFD 1 -template fd -downsample 2 -window_flag 0 "
           "--outname /tmp/tm4.h5"),
    ("pe", "-Tobs $TOBS2 -M 1e6 -mu 10.0 -e0 0.35 -eps 1e-2 -dt 10.0 -injectFD 1 "
           "-template fd -nwalkers 16 -ntemps 1 -downsample 100 -nsteps 1 --outname /tmp/tm5.h5"),
    ("scan", "-Tobs 1.0 -eps 1e-2 -dt 10.0 -nsteps $NSCAN --outname /tmp/tm_scan.h5"),
)


def row_flags(quick: bool = False) -> list[tuple[str, list[str]]]:
    """The six runs as (cli, argv): ``"pe"`` or ``"scan"`` and the flags
    with the shell variables of the full (or ``quick``) size filled in."""
    subst = dict(SIZES[bool(quick)], PAPER=PAPER)
    out = []
    for cli, flags in ROWS:
        words = []
        for word in flags.split():
            words += subst[word[1:]].split() if word.startswith("$") else [word]
        out.append((cli, words))
    return out


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


@contextlib.contextmanager
def fixed_p0(p0):
    """With ``p0`` given, `get_p_at_t` returns it instead of solving (a
    duration solve shared by several runs of one source); else nothing
    changes."""
    if p0 is None:
        yield
        return
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models import inspiral

    solve = inspiral.get_p_at_t
    inspiral.get_p_at_t = lambda *a, **k: torch.tensor([float(p0)], dtype=torch.float64)
    try:
        yield
    finally:
        inspiral.get_p_at_t = solve


def pe_args(argv):
    """``argv`` parsed by the port's PE CLI."""
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe

    return emri_pe.build_parser().parse_args(argv)


def run_pe(argv, device, outdir=None, backend=None, p0=None) -> dict:
    """One PE run of the matrix: `run_emri_pe` on ``argv`` with its chain
    file moved into ``outdir``, or the in-memory ``backend``
    (`inference.backends.memory.Backend`) where given; ``p0`` skips the
    duration solve (`fixed_p0`). Returns run_emri_pe's dict with ``nf``,
    ``ll_truth`` (log L at the truth, its seconds in ``timing``) and
    ``seconds``."""
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe

    args = pe_args(argv)
    if outdir is not None:
        args.outname = os.path.join(outdir, os.path.basename(args.outname))
    tic = time.perf_counter()
    with fixed_p0(p0):
        out = emri_pe.run_emri_pe(args, backend=backend, device=device)
    t_ll = time.perf_counter()
    out["ll_truth"] = float(out["likelihood"](out["truth"][None])[0])
    out["timing"]["ll_truth_s"] = time.perf_counter() - t_ll
    out["seconds"] = time.perf_counter() - tic
    out["nf"] = len(out["f_arr"])
    return out


def stages(out) -> str:
    """A PE run's seconds by stage: the duration solve, the template's
    injection call, the rest of the set-up (the injection prologue, a TD
    injection, the likelihood), the walkers' start, the steps and log L at
    the truth."""
    t = out["timing"]
    rest = out["seconds"] - t["p0_solve_s"] - t["injection_s"] - t["sampling_s"] - t["ll_truth_s"]
    return (f"solve {t['p0_solve_s']:.1f} s, template injection {t['injection_s']:.1f} s, "
            f"other set-up {rest:.1f} s, start {t['start_s']:.1f} s, steps {t['steps_s']:.1f} s, "
            f"log L at the truth {t['ll_truth_s']:.1f} s")


def run_scan(argv, device, outdir=None) -> dict:
    """The scan row: `run_check` on ``argv``, writing its file into
    ``outdir`` when given (needs h5py). Returns its results with
    ``seconds``."""
    from emri_frequencydomainwaveforms_tpu_torch.cli import check_mode_by_mode

    args = check_mode_by_mode.build_parser().parse_args(argv)
    if outdir is not None:
        args.outname = os.path.join(outdir, os.path.basename(args.outname))
    tic = time.perf_counter()
    res = check_mode_by_mode.run_check(args, device=device, write=outdir is not None)
    res["seconds"] = time.perf_counter() - tic
    return res


def parse_rows(text: str) -> list[int]:
    """``"1,3"`` / ``"2-5"`` / ``"all"`` -> the 1-based row numbers."""
    if text == "all":
        return list(range(1, len(ROWS) + 1))
    rows = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        rows += range(int(lo), int(hi or lo) + 1)
    if not rows or min(rows) < 1 or max(rows) > len(ROWS):
        raise ValueError(f"rows {text!r}: each in 1..{len(ROWS)}")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the original's QUICK=1 sizes (Tobs 0.1, downsample 32, 2 scan draws)")
    ap.add_argument("--rows", default="all", help="rows to run, e.g. 1,3 or 2-5 (default all)")
    ap.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    import torch

    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()  # the peak-memory counters need the allocator up
    h5 = have_h5py()
    if not h5:
        print("chain backend: memory (h5py absent)", flush=True)
    chosen = parse_rows(args.rows)
    flags = row_flags(args.quick)
    outdir = tempfile.mkdtemp(prefix="torch_test_matrix_") if h5 else None
    results = {}
    try:
        for i in chosen:
            cli, argv_i = flags[i - 1]
            print(f"[row {i}] {cli}: {' '.join(argv_i)}", flush=True)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            if cli == "pe":
                out = run_pe(argv_i, device, outdir, None if h5 else Backend())
                chain_ok = bool(np.isfinite(out["chain"]).all())
                summary = (f"p0 {out['p0']:.6f}, {out['n_knots']} knots, nf {out['nf']}, "
                           f"injection SNR {out['snr']:.4f}, log L at the truth "
                           f"{out['ll_truth']:.6e}, chain finite {chain_ok}; {stages(out)}")
                keep = {k: out[k] for k in ("p0", "n_knots", "nf", "snr", "ll_truth")}
            else:
                out = run_scan(argv_i, device, outdir)
                summary = (f"{len(out['SNR'])} draws done, {len(out['failed_points'])} failed, "
                           f"hann mismatch max {max(out['mismatch']['hann'], default=np.nan):.3e}")
                keep = {"draws": len(out["SNR"]), "failed": len(out["failed_points"])}
            if cuda:
                torch.cuda.synchronize(device)
                keep["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
                summary += f", peak device memory {keep['peak_gb']:.2f} GB"
            keep["seconds"] = out["seconds"]
            print(f"[row {i}] {summary}; {out['seconds']:.1f} s", flush=True)
            results[i] = keep
            del out
    finally:
        if outdir is not None:
            shutil.rmtree(outdir, ignore_errors=True)
    if len(chosen) == len(ROWS):
        print(f"test matrix: all {len(ROWS)} runs completed", flush=True)
    else:
        print(f"test matrix: runs {', '.join(map(str, chosen))} completed", flush=True)
    return results


if __name__ == "__main__":
    main()
