"""The tool twins and the RWZ solver modules they use load neither JAX nor
the JAX package.

Each twin (and each solver module) is imported in a fresh interpreter; the
modules the import adds must hold neither ``jax`` / ``jaxlib`` nor
``emri_frequencydomainwaveforms_tpu``. Each twin's ``main`` must also
accept ``--device`` and ``--help``. The port package itself is checked the
same way in ``tests/test_torch_ops.py::test_port_imports_no_jax``.
"""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

TWINS = [
    "tools.torch_xcheck_diag",
    "tools.torch_negative_f_survey",
    "tools.torch_convergence_l56",
    "tools.torch_derive_multipoles",
    "tools.rwz.torch_calibrate",
    "tools.rwz.torch_calibrate_ecc",
    "tools.rwz.torch_calibrate_ecc_extend",
    "tools.rwz.torch_holdout_check",
    "tools.rwz.torch_ecc_flux_check",
    "tools.rwz.torch_pn_ecc_flux",
    "tools.torch_test_matrix",
]
SOLVER = [f"tools.rwz.{m}" for m in
          ("solver", "circular", "eccentric", "gr", "derive_even", "derive_odd",
           "generated_even")]


def test_twins_and_solver_import_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {TWINS + SOLVER!r}:\n"
        "    importlib.import_module(name)\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.amplitude\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.rwz_calibration\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.prior\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'emri_frequencydomainwaveforms_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or 'jax' in before\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


@pytest.mark.parametrize("name", TWINS)
def test_twin_help_names_the_device(name):
    """``--help`` runs with no JAX in the process and lists ``--device``."""
    code = (
        "import runpy, sys\n"
        "before = set(sys.modules)\n"
        f"sys.argv = [{name!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({name!r}, run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code in (0, None), exc.code\n"
        "new = set(sys.modules) - before\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'emri_frequencydomainwaveforms_tpu')"
        " for m in new)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "--device" in res.stdout


def test_twin_sources_import_no_jax_and_no_original():
    """No line of a twin or a solver module imports JAX, the JAX package or
    an original tool that imports it, at module level or inside a
    function (the fresh-interpreter test above sees only the imports that
    run on import)."""
    import re

    originals = ("xcheck_diag", "negative_f_survey", "convergence_l56", "derive_multipoles",
                 "calibrate", "calibrate_ecc", "calibrate_ecc_extend", "holdout_check",
                 "ecc_flux_check", "pn_ecc_flux")
    jax_import = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|emri_frequencydomainwaveforms_tpu)(\s|\.|$)")
    original_import = re.compile(
        r"^\s*(from\s+(\.|tools\.|tools\.rwz\.)?(" + "|".join(originals) + r")\s+import"
        r"|import\s+tools\.(rwz\.)?(" + "|".join(originals) + r")(\s|$))")
    files = [ROOT / (name.replace(".", "/") + ".py") for name in TWINS + SOLVER]
    bad = [f"{f.relative_to(ROOT)}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines())
           if jax_import.match(line) or original_import.match(line)]
    assert not bad, bad
    assert original_import.match("from .calibrate_ecc import clean_table")
    assert not original_import.match("from .torch_calibrate_ecc import clean_table")
