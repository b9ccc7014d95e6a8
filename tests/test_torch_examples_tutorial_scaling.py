"""The port's FD-waveform tutorial on the CPU, sections 4-5.

``examples/torch_fd_waveforms_tutorial.py`` runs sections 4 and 5 through
its ``main(["--device", "cpu", "--T", "0.05", "--sections", "4-5"])`` at
the reference tutorial's CI-quick size (0.05 yr, dt = 10 s; the production
physics). They are held to the tutorial's own claims: the mass-invariance
collapse < 1e-2 and the 100x downsampled grid within 1e-3 of the full one
on the shared bins (the reference tutorial takes over 3 minutes on an
8-core CPU, so these are not recomputed through the JAX package). Sections
1-3, against the JAX package, are in ``tests/test_torch_examples_tutorial.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_examples import load_example

T_QUICK = 0.05


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_tutorial_scaling_sections(capsys):
    checks = load_example("torch_fd_waveforms_tutorial").main(
        ["--device", "cpu", "--T", str(T_QUICK), "--sections", "4-5"])
    out = capsys.readouterr().out
    assert "[4]" in out and "[5]" in out
    assert "[1]" not in out and "[3]" not in out
    assert set(checks) == {"collapse", "downsample_bins", "downsample_rel"}
    assert all(np.isfinite(v) for v in checks.values())
    assert checks["collapse"] < 1e-2
    assert checks["downsample_bins"] > 0 and checks["downsample_rel"] < 1e-3
