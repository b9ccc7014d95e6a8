"""What the harness and the reference load: never JAX or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's), and the reference nothing of the program."""

import json
import subprocess
import sys

from conftest import REPO, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "emri_frequencydomainwaveforms_tpu"}
PORT = "emri_frequencydomainwaveforms_tpu_torch"


def _top_level_after(code: str) -> set[str]:
    probe = (f"import sys; sys.path.insert(0, {REPO!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    loaded = _top_level_after(
        "import benchmark.reference.plain, benchmark.reference.stretch")
    assert not loaded & FORBIDDEN
    assert PORT not in loaded


def test_a_whole_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    loaded = _top_level_after(
        "import time; from benchmark.lib import harness; "
        f"harness.run_cell(harness.Cell('wf_tiny.dp5_b4', {root!r}), seed=1, seconds=0.2, "
        "trace=True, device='cpu', t_start=time.perf_counter())")
    assert not loaded & FORBIDDEN
    assert PORT in loaded


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, REPO)
    from benchmark.lib import harness

    saved = dict(sys.modules)
    try:
        sys.modules["emri_frequencydomainwaveforms_tpu_torch_probe"] = sys
        sys.modules["jaxtyping_probe"] = sys
        assert harness.forbidden_modules() == sorted(
            m for m in saved if m.split(".")[0] in FORBIDDEN)
        sys.modules["jax"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        for k in ("emri_frequencydomainwaveforms_tpu_torch_probe", "jaxtyping_probe", "jax"):
            sys.modules.pop(k, None)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pe_1yr.t4w32",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_in_a_directory_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(f"{REPO}/benchmark", tmp_path / "benchmark")
    shutil.copy(f"{REPO}/BENCHMARK.json", tmp_path)
    probe = ("import sys, time; sys.path.insert(0, '.'); from benchmark.lib import harness; "
             "harness.run_cell(harness.Cell('wfbatch_1yr.dp5_b128', '.'), seed=1, seconds=0.1, "
             "trace=False, device='cpu', t_start=time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert PORT in out.stderr and "No module named" in out.stderr
