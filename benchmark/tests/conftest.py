"""Fixtures of the benchmark's CPU tests: a checkout-like root in a temp
directory holding the tiny cells of ``tiny/`` (configurations, traffic
mixes, limits and a BENCHMARK.json of their own) beside the real metric
readers, so that the harness runs them as it runs the real cells."""

import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def make_root(tmp_path) -> str:
    root = str(tmp_path / "checkout")
    os.makedirs(os.path.join(root, "benchmark"))
    for d in ("configs", "traffic", "cells"):
        shutil.copytree(os.path.join(HERE, "tiny", d), os.path.join(root, "benchmark", d))
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"),
                    os.path.join(root, "benchmark", "metrics"))
    shutil.copy(os.path.join(HERE, "tiny", "BENCHMARK.json"), root)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run_tiny(root, workload, *, seed=3000000001, seconds=0.5, trace=False, faults=None,
             control=False):
    import time

    from benchmark.lib import harness

    cell = harness.Cell(workload, root)
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                            t_start=time.perf_counter(), faults=faults, control=control)
