"""The benchmark is driven by its data: every piece is found by name, and a
new configuration, traffic mix, metric and cell run as new files with no
edit of a file that is there."""

import json
import os
import re
import time

import pytest
import torch

from conftest import REPO, make_root, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_piece_of_the_spec_is_found_by_name():
    from benchmark.lib import harness

    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"], REPO)
        assert cell.limits and cell.driver.__name__.endswith(cell.traffic["driver"])
        for trace in (False, True):
            for m in cell.metrics(trace):
                assert callable(cell.reader(m["name"]))
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))


def test_names_units_and_keys_keep_to_the_contract():
    spec = _spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:  # the metric it moves is reported in each of its cells
            moved = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    assert all(w["chips"] in (1, 4) for w in spec["workloads"])
    rs = spec["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_config_mix_metric_and_cell_run_as_files_alone(tmp_path):
    root = make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "wf_tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="wf_tiny_k6", k_max=6, harmonics=cfg["harmonics"][:6])
    with open(os.path.join(bench, "configs", "wf_tiny_k6.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "dp5_b4.json")) as f:
        mix = json.load(f)
    mix.update(batch=2, keep_lanes=2)
    with open(os.path.join(bench, "traffic", "dp5_b2.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "batch_wall_ms.py"), "w") as f:
        f.write("def read(run):\n    return 1e3 * run.wall_s / len(run.walls)\n")
    with open(os.path.join(bench, "cells", "wf_tiny_k6.dp5_b2.json"), "w") as f:
        json.dump({"checks": {"spectra_rel_l2_mean": 1e-3}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "wf_tiny_k6", "source": "tests",
                            "file": "benchmark/configs/wf_tiny_k6.json", "reduced": [],
                            "why": "a new configuration"})
    spec["workloads"].append({"name": "wf_tiny_k6.dp5_b2", "config": "wf_tiny_k6",
                              "traffic": "dp5_b2", "chips": 1, "why": "a new cell"})
    spec["end_to_end"].append({"name": "batch_wall_ms", "unit": "ms", "better": "lower",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["wf_tiny_k6.dp5_b2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    res = run_tiny(root, "wf_tiny_k6.dp5_b2")
    assert res["correct"] and res["attempted"] % 2 == 0
    assert res["metrics"]["batch_wall_ms"]["value"] > 0
    assert "batch_wall_ms" not in run_tiny(root, "wf_tiny.dp5_b4")["metrics"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.lib import harness

    root = make_root(tmp_path)
    res = harness.run_cell(harness.Cell("wf_tiny.dp5_b4", root), seed=5, seconds=0.5,
                           trace=True, device="cuda:0", t_start=time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["metrics"]["device_idle_pct.wf"]["value"] < 100
