#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (at the root of the checkout) on the
machine it is started on, from the root of the checkout. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
(spans around the layers' entry calls, the device profiled over one step
run before the window). The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, beside its
limit). Exits non-zero, printing no result, without a CUDA device, with
fewer devices than the cell asks for, or when JAX or the JAX package is
loaded once the window has closed.

The process keeps PyTorch's and numpy's CPU work on one thread (unless
``OMP_NUM_THREADS`` says otherwise). The program builds its kernels into
its own ``_build/`` directory inside the checkout; nothing is written
outside the checkout, ``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread for PyTorch's and numpy's CPU work: the process's load stays one
# launching thread, which steadies the host-bound steps
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import harness

    cell = harness.Cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              device="cuda:0", t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
