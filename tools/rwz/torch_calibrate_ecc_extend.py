"""Extend the committed eccentric calibration solve, on the PyTorch port:
e past 0.55, l = 5, 6.

The port's counterpart of ``tools/rwz/calibrate_ecc_extend.py``. It reuses
the persisted raw solve (``tools/rwz/_rwz_ecc_data_raw.npz``: l <= 4 rows
on a 16 x 10 (u, e) grid with e <= 0.55, never re-run) and solves ONLY the
new cells:

  stage A: existing l <= 4 rows x the 3 added e-columns
           (0.6056, 0.6611, 0.7167 -- same DE, N_E 10 -> 13);
  stage B: new l = 5, 6 rows (m = 0..l, n in [N_LO, N_HI]) x all 13 columns.

The baseline convention is the one of `torch_calibrate_ecc` (f64 spectral
projection, tail + factorized + circular B_lm, NO eccentric residual), so
merged old and new cells live on one consistent surface. It checkpoints
after every grid column (``--checkpoint``, default
tools/rwz/_rwz_ecc_ext_ckpt.npz) so an interrupted run resumes without
re-solving; ``--assemble`` skips straight to clean_table + write_table from
the checkpoint (the committed table is exactly that of the committed
checkpoint).

Writes ``emri_frequencydomainwaveforms_tpu_torch/models/_rwz_ecc_data.py``
unless ``--out`` names another file.

Run:  python -m tools.rwz.torch_calibrate_ecc_extend [--lmax 6] [--ne-new 3]
      [--assemble] [--out <path>] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .torch_calibrate_ecc import (
    N_HI,
    N_LO,
    OUT,
    _err_summary,
    calibrate_node,
    clean_table,
    mode_index,
    p_of_node,
    write_table,
)

RAW = "tools/rwz/_rwz_ecc_data_raw.npz"
CKPT = "tools/rwz/_rwz_ecc_ext_ckpt.npz"


def _load_ckpt(path):
    dat = np.load(path)
    keys = [tuple(int(v) for v in k) for k in dat["keys"]]
    rows = {k: dat["rows"][i].copy() for i, k in enumerate(keys)}
    errs = {k: dat["errs"][i].copy() for i, k in enumerate(keys)}
    done = set(map(tuple, dat["done"].reshape(-1, 2).tolist()))
    grid = dat["grid"]
    return rows, errs, done, grid


def _save_ckpt(path, rows, errs, done, grid):
    keys = sorted(rows)
    np.savez_compressed(
        path + ".tmp.npz",
        keys=np.array(keys, dtype=np.int64),
        rows=np.stack([rows[k] for k in keys]),
        errs=np.stack([errs[k] for k in keys]),
        done=np.array(sorted(done), dtype=np.int64).reshape(-1, 2),
        grid=grid,
    )
    os.replace(path + ".tmp.npz", path)


def assemble(checkpoint, out):
    """clean_table + write_table from a checkpoint, no solving."""
    rows, errs, done, grid = _load_ckpt(checkpoint)
    u0, du, e0, de, nu, ne = grid
    rows, errs = clean_table(rows, errs)
    _err_summary(rows, errs)
    write_table(out, rows, u0, du, e0, de, int(nu), int(ne), errs=errs)
    return rows, errs


def extended_start(raw_path, ne_new):
    """(rows, errs, grid, ne_old) of the raw solve widened by ``ne_new``
    e-columns (R = 1, err = 0 in the new cells)."""
    raw = np.load(raw_path)
    r_keys = [tuple(int(v) for v in k) for k in raw["keys"]]
    u0, du, e0, de, nu_old, ne_old = raw["grid"]
    nu, ne_old = int(nu_old), int(ne_old)
    ne = ne_old + ne_new
    grid = np.array([u0, du, e0, de, nu, ne])
    rows = {k: np.ones((nu, ne), dtype=complex) for k in r_keys}
    errs = {k: np.zeros((nu, ne)) for k in r_keys}
    for i, k in enumerate(r_keys):
        rows[k][:, :ne_old] = raw["rows"][i]
        errs[k][:, :ne_old] = raw["errs"][i]
    return rows, errs, grid, ne_old


def work_list(mode_idx, ne_old, ne):
    """Stage A first (the e > 0.55 columns of the l <= 4 rows), then stage
    B (the l = 5, 6 rows over every column): (stage, column, keys)."""
    work = []
    for j in range(ne_old, ne):
        work.append(("A", j, [k for k in mode_idx if k[0] <= 4]))
    for j in range(ne):
        work.append(("B", j, [k for k in mode_idx if k[0] > 4]))
    return work


def n_chi_of(i, j, nu, ne_old):
    """Quadrature points at grid row i, column j: finer at high e (more
    peaked orbit functionals) and near the separatrix."""
    if j >= ne_old:
        return 2048 if i < nu // 3 else 1024
    return 1024 if i < nu // 3 else 512


def _skip_line(key, p, e, exc):
    return f"  skip {key} @ ({p:.3f},{e:.3f}): {exc}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmax", type=int, default=6)
    ap.add_argument("--ne-new", type=int, default=3,
                    help="e-columns appended past the raw table's range")
    ap.add_argument("--raw", type=str, default=RAW)
    ap.add_argument("--checkpoint", type=str, default=CKPT)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--assemble", action="store_true",
                    help="no solving: clean + write from the checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device of the model side (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if args.assemble:
        assemble(args.checkpoint, args.out)
        return

    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # --- grids: same u nodes and DE as the committed raw solve ----------
    rows, errs, grid, ne_old = extended_start(args.raw, args.ne_new)
    u0, du, e0, de, nu, ne = grid
    nu, ne = int(nu), int(ne)
    us = u0 + du * np.arange(nu)
    es = e0 + de * np.arange(ne)

    if os.path.exists(args.checkpoint):
        rows, errs, done, ck_grid = _load_ckpt(args.checkpoint)
        assert np.allclose(ck_grid, grid), "checkpoint grid mismatch"
        print(f"resuming: {len(done)} columns already solved", flush=True)
    else:
        done = set()

    table = default_mode_table(max(abs(N_LO), N_HI), l_max=args.lmax)
    mode_idx = mode_index(table, [(l, m) for l in range(2, args.lmax + 1)
                                  for m in range(0, l + 1)], range(N_LO, N_HI + 1))
    for k in mode_idx:
        if k not in rows:
            rows[k] = np.ones((nu, ne), dtype=complex)
            errs[k] = np.zeros((nu, ne))

    t_start = time.time()
    for stage, j, keys in work_list(mode_idx, ne_old, ne):
        if (ord(stage), j) in done:
            continue
        e = float(es[j])
        for i, u in enumerate(us):
            p = p_of_node(u, e)
            node = calibrate_node(p, e, n_chi_of(i, j, nu, ne_old), table, mode_idx, keys,
                                  device=device, skip_line=_skip_line)
            for key, (r, err) in node.items():
                rows[key][i, j] = r
                errs[key][i, j] = err
            print(f"{stage} col {j} row {i} p={p:7.3f} e={e:.3f}: "
                  f"{len(node)} modes, {time.time() - t_start:7.0f}s",
                  flush=True)
        done.add((ord(stage), j))
        _save_ckpt(args.checkpoint, rows, errs, done, grid)
        print(f"checkpoint: stage {stage} column {j} done", flush=True)

    rows, errs = clean_table(rows, errs)
    _err_summary(rows, errs)
    write_table(args.out, rows, u0, du, e0, de, nu, ne, errs=errs)


if __name__ == "__main__":
    sys.exit(main())
