"""Each traffic kind and its metric readers on the tiny cells, on the CPU."""

import pytest

from conftest import run_tiny

CELLS = ("pe_tiny.t2w4", "wf_tiny.dp5_b4", "wf_tiny.quad_b4")


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_is_correct_and_reports_its_end_to_end_metrics(tiny_root, workload):
    res = run_tiny(tiny_root, workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    rate = "posterior_evals_per_s" if workload.startswith("pe") else "waveforms_per_s"
    assert set(res["metrics"]) == {rate, "setup_s"}  # no device: no peak memory
    assert res["metrics"][rate]["value"] > 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_span_metrics(tiny_root, workload):
    res = run_tiny(tiny_root, workload, trace=True)
    assert res["correct"]
    got = set(res["metrics"])
    spans = {"amplitudes_ms", "level1_ms"}
    if workload.startswith("pe"):
        spans |= {"sampler_host_ms", "likelihood_call_ms", "trajectory_dp5_ms"}
    else:
        spans |= {"trajectory_dp5_ms" if "dp5" in workload else "trajectory_quad_ms"}
    suffix = ".pe" if workload.startswith("pe") else ".wf"
    assert {s + suffix for s in spans} <= got
    # the device's metrics need the card's trace: none from a CPU run
    assert not any(k.startswith(("device_idle", "launches_", "fd_dense_roof", "row_cumsum_roof"))
                   for k in got)
    assert all(m["value"] > 0 for m in res["metrics"].values())
