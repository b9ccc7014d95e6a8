"""The frozen yardstick equals its sources as they are: the peaks, the
kept-cell counts and the byte bounds of `benchmark/lib/roofline.py`."""

import os

import numpy as np
import pytest
import torch

from conftest import REPO


def test_roofline_yardstick_equals_its_sources():
    import importlib.util

    from benchmark.lib import roofline
    from emri_frequencydomainwaveforms_tpu_torch.testing import fd_dense_cases as cases

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("HBM_BYTES_PER_S", "F32_OPS_PER_S", "F64_OPS_PER_S", "OPS_PER_PAIR",
                 "CELL_BYTES", "SLOT_BYTES"):
        assert getattr(roofline, name) == getattr(smoke, name), name
    rng = np.random.default_rng(11)
    for r, nf in ((8, 900), (64, 20000), (1, 300)):
        groups = cases.random_groups(rng, 4, [(5, 12), (2, 6)], r, nf)
        assert roofline.kept_runs(groups, r, nf) == cases.kept_runs(groups, r, nf)
        assert roofline.kept_pairs(groups, r, nf) == cases.kept_pairs(groups, r, nf)
        ms, _ = smoke.bound(cases, groups, r, nf)
        assert roofline.fd_dense_bound_s(groups, r, nf) == pytest.approx(ms / 1e3, rel=1e-12)
    x = torch.zeros(64, 48, 100, dtype=torch.float32)
    assert roofline.row_cumsum_bound_s(x) == pytest.approx(
        2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S, rel=1e-12)
