"""The pe driver runs the PE command line's own flow: `run_emri_pe` with its
duration solve replaced by the configuration's p0 and its flux grid by the
configuration's table, on the in-memory backend, draws the same walkers'
start and takes the same first step as the driver on the same seed."""

import json
import os

import numpy as np
import torch

from conftest import HERE


def test_the_pe_driver_takes_the_clis_first_step(tiny_root, monkeypatch):
    from benchmark.drivers import common, pe_sampler
    from benchmark.lib import harness
    from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
    from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
    from emri_frequencydomainwaveforms_tpu_torch.models import inspiral

    with open(os.path.join(HERE, "tiny", "configs", "pe_tiny.json")) as f:
        cfg = json.load(f)
    seed = 3000000123
    monkeypatch.setattr(inspiral, "get_p_at_t",
                        lambda *a, **k: torch.tensor([cfg["p0"]], dtype=torch.float64))
    monkeypatch.setattr(inspiral, "flux_model",
                        lambda flux, dev, grid=None: common.program_flux_grid(cfg, dev))
    args = emri_pe.build_parser().parse_args(
        pe_sampler._argv(cfg) + ["-nsteps", "1", "--seed", str(seed)])
    cli = emri_pe.run_emri_pe(args, backend=Backend(), device="cpu")
    table = cli["table"]
    assert [list(x) for x in zip(table.ls.tolist(), table.ms.tolist(), table.ns.tolist())] \
        == cfg["harmonics"]

    cell = harness.Cell("pe_tiny.t2w4", tiny_root)
    ctx = harness.Context(cell, seed, 0.0, False, "cpu")
    st = pe_sampler.setup(ctx)
    win = pe_sampler.window(ctx, st)
    first = win.kept["first_step"]
    assert np.array_equal(st["start"], cli["start"])
    backend = cli["backend"]
    assert torch.equal(torch.as_tensor(backend.get_chain()["emri"][0][:, :, 0, :]),
                       first["coords_after"])
    assert torch.equal(torch.as_tensor(backend.get_log_like()[0]), first["log_like_after"])
