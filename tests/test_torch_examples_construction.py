"""The port's FD-construction example on the CPU, against the JAX
package's at the same arguments.

``examples/torch_fd_construction.py`` runs through its
``main(["--device", "cpu"])`` at its default (CI-quick) size; its returned
checks are held to the same quantities printed by the reference's
``examples/fd_construction.py`` (its ``main()``), each to its printed
digits: the knot count and the in-band bins exactly or to 0.1 %, the band
edges to 5e-5 mHz, the peak |h+~| to 5e-4 relative, the FD vs fft(TD) dt
mismatch to 1e-3 relative and the mass-invariance ratio to 5e-5.
"""

import os
import re
import runpy
import sys

import pytest
import torch

from tests.test_torch_examples import EXAMPLES, load_example


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def printed(text, pattern):
    """The float(s) that ``pattern``'s groups capture in ``text``."""
    m = re.search(pattern, text)
    assert m, f"no line matches {pattern!r}"
    vals = [float(g) for g in m.groups()]
    return vals if len(vals) > 1 else vals[0]


def test_fd_construction_matches_the_reference(capsys, monkeypatch):
    checks = load_example("torch_fd_construction").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert checks["mismatch"] < checks["gate"] and abs(checks["ratio_median"] - 1.0) < 0.05

    monkeypatch.setattr(sys, "argv", ["fd_construction.py"])
    runpy.run_path(os.path.join(EXAMPLES, "fd_construction.py"))["main"]()
    ref = capsys.readouterr().out
    assert ref.rstrip().endswith("OK")
    assert checks["n_live"] == printed(ref, r"trajectory: (\d+) adaptive knots")
    f_lo, f_hi = printed(ref, r"f_22 sweeps ([\d.]+) -> ([\d.]+) mHz")
    assert abs(checks["f_start"] * 1e3 - f_lo) <= 5e-5 and abs(checks["f_end"] * 1e3 - f_hi) <= 5e-5
    bins, peak = printed(ref, r"FD kernel: (\d+) in-band bins of \d+; peak \|h\+~\| = (\S+)")
    assert abs(checks["in_band_bins"] - bins) <= 1e-3 * bins
    assert abs(checks["peak_hp"] - peak) <= 5e-4 * peak
    mm = printed(ref, r"fft\(TD\)\*dt Hann mismatch: (\S+)")
    assert abs(checks["mismatch"] - mm) <= 1e-3 * mm
    ratio = printed(ref, r"ratio median (\S+)")
    assert abs(checks["ratio_median"] - ratio) <= 5e-5
