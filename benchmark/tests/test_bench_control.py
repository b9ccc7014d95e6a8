"""The control (the reference with float32 trajectory phases in the
program's place) fails the cells' numbers, at a size a test run can hold;
the program at the same size passes them.

At full size the control is read on the card with ``benchmark/control.py``
(PERF.md gives its readings); these are the tiny cells' readings."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("workload", ["pe_tiny.t2w4", "wf_tiny.dp5_b4", "wf_tiny.quad_b4"])
def test_control_fails_where_the_program_passes(tiny_root, workload):
    res = run_tiny(tiny_root, workload, control=True)
    assert res["correct"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items()), res["control"]
