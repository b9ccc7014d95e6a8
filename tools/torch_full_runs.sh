#!/usr/bin/env bash
# The tool twins at their full sizes on the current CUDA device, one command:
#
#     bash tools/torch_full_runs.sh [OUT]          (default OUT: chiprun_out/tools)
#
# Each twin's output goes to OUT/<name>.txt and its exit code and milliseconds
# to OUT/seconds.txt.
# The RWZ solves run on the host (one process each, started together); the
# card-side twins run one after the other meanwhile. The calibrators write
# their tables into OUT, never into the package, and OUT/tables.txt holds
# their largest deviation from the committed port copies. The negative-f
# survey's batched duration solve is checked against two of its draws
# solved alone (OUT/negative_f.txt).
set -u
OUT=${1:-chiprun_out/tools}
mkdir -p "$OUT"
export PYTHONPATH=.
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
: > "$OUT/seconds.txt"

run() {
    local name=$1
    shift
    local t0
    t0=$(date +%s%N)
    "$@" > "$OUT/$name.txt" 2>&1
    local rc=$?
    echo "$name rc=$rc ms=$(( ($(date +%s%N) - t0) / 1000000 ))" >> "$OUT/seconds.txt"
}

# host-bound RWZ solves, each in a process of its own, one thread each
export OMP_NUM_THREADS=1
run calibrate python -m tools.rwz.torch_calibrate --out "$OUT/_rwz_calibration_data.py" &
run holdout python -m tools.rwz.torch_holdout_check &
run ecc_flux python -m tools.rwz.torch_ecc_flux_check &
run pn_quick python -m tools.rwz.torch_pn_ecc_flux --quick --model &
run derive python tools/torch_derive_multipoles.py &
run ecc_from_raw python -m tools.rwz.torch_calibrate_ecc --from-raw \
    tools/rwz/_rwz_ecc_data_raw.npz --out "$OUT/ecc_from_raw.py" &
run ecc_assemble python -m tools.rwz.torch_calibrate_ecc_extend --assemble \
    --out "$OUT/_rwz_ecc_data.py" &

# the card-side twins, one after the other
unset OMP_NUM_THREADS
run xcheck_cpu python tools/torch_xcheck_diag.py --device cpu --quick --save "$OUT/xcheck_cpu.npz"
run xcheck python tools/torch_xcheck_diag.py --compare "$OUT/xcheck_cpu.npz"
run negative_f python - <<'EOF'
import numpy as np

from tools import torch_negative_f_survey as survey

res = survey.main([])
fr = res["fracs"]
print(f"first 24 draws: median {np.median(fr[:24]):.3e}  p95 {np.percentile(fr[:24], 95):.3e}  "
      f"max {fr[:24].max():.3e}")
src = survey.draw_sources(32, 2601996)
for k in (0, 5):
    alone = survey.solve_p0(src[k:k + 1], 1.0, None)[0]
    print(f"draw {k}: p0 {res['p0'][k]!r} in the 32-draw batch, {alone!r} alone, "
          f"equal: {alone == res['p0'][k]}")
EOF
run l56 python tools/torch_convergence_l56.py
wait

python - "$OUT" > "$OUT/tables.txt" 2>&1 <<'EOF'
import filecmp
import importlib.util
import os
import sys

import numpy as np

out = sys.argv[1]
models = "emri_frequencydomainwaveforms_tpu_torch/models"


def load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


b_new = load(f"{out}/_rwz_calibration_data.py").B_TABLE
b_old = load(f"{models}/_rwz_calibration_data.py").B_TABLE
rel = {k: float(np.max(np.abs(b_new[k] / b_old[k] - 1.0))) for k in b_old}
worst = max(rel, key=rel.get)
print(f"B_TABLE: {len(b_new)} rows regenerated, {len(b_old)} committed; largest |B_new / "
      f"B_committed - 1| {rel[worst]:.3e} at {worst}; median over rows "
      f"{np.median(list(rel.values())):.3e}")
same = filecmp.cmp(f"{out}/_rwz_ecc_data.py", f"{models}/_rwz_ecc_data.py", shallow=False)
print(f"_rwz_ecc_data.py from the committed checkpoint (--assemble): byte-identical to the "
      f"committed copy: {same}")
r_raw = load(f"{out}/ecc_from_raw.py")
r_old = load(f"{models}/_rwz_ecc_data.py")
n_e = r_raw.N_E
inner = max(float(np.max(np.abs(r[:, :-1] - r_old.R_TABLE[k][:, :n_e - 1])))
            for k, r in r_raw.R_TABLE.items())
edge = max(float(np.max(np.abs(r[:, -1] - r_old.R_TABLE[k][:, n_e - 1])))
           for k, r in r_raw.R_TABLE.items())
print(f"--from-raw table ({len(r_raw.R_TABLE)} rows, {r_raw.N_U} x {n_e}) vs the committed "
      f"({len(r_old.R_TABLE)} rows, {r_old.N_U} x {r_old.N_E}): max |dR| {inner:.3e} on e-columns "
      f"0..{n_e - 2}, {edge:.3e} on column {n_e - 1}")
EOF
cat "$OUT/seconds.txt"
