#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` for the program and for its
control, on several seeds of one cell, in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --seconds 5 \
        [--out control.jsonl]

For each seed: one run of the cell as the benchmark makes it (set-up, a
window of ``--seconds``, the reference's comparison), then the control (the
reference with float32 trajectory phases, `reference.plain`) in the
program's place on the same inputs. Prints, and appends to ``--out``, one
JSON line per seed: the program's numbers and the control's. The limits in
``benchmark/cells/<workload>.json`` are set from these readings; the
benchmark's own runs do not run the control.
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
    p = argparse.ArgumentParser(description="program and control readings of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import harness

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    cell = harness.Cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                               device="cuda:0", t_start=time.perf_counter(), control=True)
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                           "program": {k: c["value"] for k, c in res["checks"].items()},
                           "control": res["control"], "metrics": res["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
