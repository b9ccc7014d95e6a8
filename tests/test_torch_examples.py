"""The port's quickstart example on the CPU, against the JAX package's
quickstart at the same arguments.

``examples/torch_quickstart.py`` runs through its
``main(["--device", "cpu"])`` at its default (CI-quick) size; its returned
checks are held to the same quantities from the reference's
``examples/quickstart.py``, run as a script (its globals carry the numbers
at full precision). Tolerances: p0 to 1e-6 relative (both bisect 44 times
on dp5 durations that agree to ~1e-9); the peak |h+~| to 1e-4 relative and
the nonzero bins to 0.1 % (the spectra agree to ~1e-5, their band edges to
a bin). `load_example` serves the other example tests
(``tests/test_torch_examples_construction.py``,
``tests/test_torch_examples_tutorial.py``).
"""

import importlib.util
import os
import runpy

import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_example(name):
    """The example module ``examples/<name>.py`` (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_matches_the_reference(capsys):
    checks = load_example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "p0 for a 0.99*T inspiral" in out and "FD waveform on" in out
    assert checks["finite"] and checks["nonzero_bins"] > 0

    ref = runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"))
    hp = ref["hp"]
    assert checks["n_bins"] == len(ref["f_np"])
    assert abs(checks["p0"] - ref["p0"]) <= 1e-6 * ref["p0"]
    assert abs(checks["peak_hp"] - np.abs(hp).max()) <= 1e-4 * np.abs(hp).max()
    nonzero = int((np.abs(hp) > 0).sum())
    assert abs(checks["nonzero_bins"] - nonzero) <= 1e-3 * nonzero
    assert np.isfinite(hp).all()
