"""The port's tracer (`utils/tracing.py`) and the benchmark readers of its
records (`benchmark/lib/program_trace.py`, `benchmark/metrics/dp5_*.py`,
`host_rest_ms.py`), on the CPU at toy sizes (no JAX needed).

Off, the tracer records nothing and the outputs are those of a traced
call, bit for bit; on (inside `tracing.enabled` or a `torch.profiler`
session) each layer's span nests under its caller's with one call id per
root, counters land on the innermost open span, and the dp5 loop's
counters agree with independent counts of its trips and knots.
"""

import gc
import importlib.util
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.models import flux as t_flux
from emri_frequencydomainwaveforms_tpu_torch.models import integrate as t_int
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PE_ARGV = ("-Tobs 0.02 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
           "-injectFD 1 -flux pm -amp flat -kmax 8 -max_steps 64")
BATCH_TREE = {"waveform.prologue": "waveform.batch", "trajectory.dp5": "waveform.prologue",
              "amplitudes": "waveform.prologue", "ylm": "waveform.prologue",
              "waveform.core": "waveform.batch", "core.prepare": "waveform.core",
              "core.level1": "waveform.core", "core.dense": "waveform.core"}
PE_TREE = {**BATCH_TREE, "waveform.prologue": "likelihood.call",
           "waveform.core": "likelihood.call", "likelihood.power": "likelihood.call"}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def batch():
    table = default_mode_table(8, l_max=2)
    gen = t_wf.FrozenFDWaveform(table, np.zeros(table.num_modes, np.int32), f0=1e-4, df=1e-7,
                                nf=1000, t_years=0.01, max_steps=64, device="cpu")
    rows = [torch.tensor(v, dtype=torch.float64) for v in
            ((12.0, 12.1, 11.9, 12.05), (0.35, 0.3, 0.4, 0.33), (0.7,) * 4, (0.5,) * 4)]
    return gen, rows


@pytest.fixture(scope="module")
def pe():
    from emri_frequencydomainwaveforms_tpu_torch.testing.pe_mesh import pe_likelihood, pe_problem

    spec = pe_problem(PE_ARGV, 9.5, "cpu", n_walkers=4)
    like, _ = pe_likelihood(spec, "cpu")
    return like, torch.as_tensor(spec["x"])


def _tree(expected):
    """Check the records against ``expected`` {child: parent}: one root
    holding every span, parents by id, one call id, each child inside its
    parent's interval. Returns the root."""
    recs = [s for s in tracing.records() if s.name != "host.gc"]
    by_id = {s.id: s for s in tracing.records()}
    roots = [s for s in recs if s.parent is None]
    assert len(roots) == 1
    root = roots[0]
    assert {s.name for s in recs} == set(expected) | {root.name}
    for s in recs:
        assert s.call == root.id
        if s is root:
            continue
        parent = by_id[s.parent]
        assert parent.name == expected[s.name], s.name
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    return root


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_off_records_nothing_and_outputs_are_bit_identical(batch, pe):
    gen, rows = batch
    like, x = pe
    assert not tracing.active()
    off_wf, off_ll = gen(*rows), like(x)
    assert tracing.records() == [] and tracing.totals() == {}
    with tracing.enabled():
        assert tracing.active()
        on_wf = gen(*rows)
        on_ll = like(x)
    assert not tracing.active()
    assert _equal(off_wf, on_wf) and torch.equal(off_ll, on_ll)
    assert tracing.records()


@pytest.mark.parametrize("how", ["enabled", "profiler"])
def test_span_tree_of_a_batch_and_a_likelihood_call(batch, pe, how):
    def session():
        if how == "enabled":
            return tracing.enabled()
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])

    gen, rows = batch
    like, x = pe
    with session():
        t0 = time.time_ns()
        gen(*rows)
        t1 = time.time_ns()
    root = _tree(BATCH_TREE)
    assert root.name == "waveform.batch" and t0 <= root.start_ns <= root.end_ns <= t1
    assert root.counters == {}
    assert tracing.totals()["level1.chunks"] == 2  # the main and the extra slots
    tracing.reset()
    with session():
        t0 = time.time_ns()
        like(x)
        t1 = time.time_ns()
    root = _tree(PE_TREE)
    assert root.name == "likelihood.call" and t0 <= root.start_ns <= root.end_ns <= t1
    assert tracing.totals()["dp5.lane_slots"] == 4 * tracing.totals()["dp5.trips"]


def test_dp5_counters_against_independent_counts():
    # lanes of different lengths: one ends at the separatrix long before the
    # horizon and waits for the others
    y0 = torch.tensor([[12.0, 0.35, 0.0, 0.0], [7.2, 0.2, 0.0, 0.0], [10.0, 0.1, 0.0, 0.0]],
                      dtype=torch.float64)
    nu = 1e-3
    stops = []

    def stop(y):
        stops.append(1)
        return t_flux.stop_condition(y)

    t_max = torch.tensor([2e5, 2e5, 2e5], dtype=torch.float64)
    with tracing.enabled(), tracing.span("outer") as outer:
        knots = t_int.integrate_inspiral(lambda y: t_flux.inspiral_rhs(y, nu), stop, y0, t_max,
                                         max_steps=256, tail_slope_mask=(0.0, 0.0, 1.0, 1.0))
    c = {k: v for k, v in tracing.totals().items() if k.startswith("dp5.")}
    assert c["dp5.trips"] == len(stops) > 0
    assert c["dp5.lane_slots"] == 3 * len(stops)
    assert c["dp5.accepted"] == int(knots.n.sum()) - 3
    assert c["dp5.accepted"] + c["dp5.rejected"] <= c["dp5.lane_slots"]
    assert c["dp5.accepted"] < c["dp5.lane_slots"]
    # the counters land on the innermost open span
    (rec,) = [s for s in tracing.records() if s.name == "outer"]
    assert rec.id == outer.id and {k: rec.counters[k] for k in c} == c
    # off: the same knots, no counters
    tracing.reset()
    stops.clear()
    again = t_int.integrate_inspiral(lambda y: t_flux.inspiral_rhs(y, nu), stop, y0, t_max,
                                     max_steps=256, tail_slope_mask=(0.0, 0.0, 1.0, 1.0))
    assert tracing.totals() == {} and len(stops) == c["dp5.trips"]
    assert _equal(knots, again)


def test_counters_land_on_the_innermost_span_and_gc_is_a_span():
    with tracing.enabled():
        tracing.count("free", 2)
        with tracing.span("a"):
            tracing.count("x")
            with tracing.span("b"):
                tracing.count("x", 3)
                gc.collect()
            tracing.count("y")
    recs = {s.name: s for s in tracing.records() if s.name != "host.gc"}
    pauses = [s for s in tracing.records() if s.name == "host.gc"]
    assert recs["a"].counters == {"x": 1, "y": 1} and recs["b"].counters == {"x": 3}
    assert recs["b"].parent == recs["a"].id and recs["a"].parent is None
    assert recs["b"].call == recs["a"].call == recs["a"].id
    assert any(s.parent == recs["b"].id and "gc.collected" in s.counters for s in pauses)
    totals = tracing.totals()
    assert totals["x"] == 4 and totals["y"] == 1 and totals["free"] == 2


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    gc.disable()
    try:
        with tracing.enabled():
            for _ in range(3):
                with tracing.span("s"):
                    pass
    finally:
        gc.enable()
    assert len(tracing.records()) == 2 and tracing.totals()["tracing.dropped_spans"] == 1


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(REPO, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, id_, parent, call, a_ms, b_ms, **counters):
    return tracing.Span(name, id_, parent, call, int(a_ms * 1e6), int(b_ms * 1e6), counters)


def test_readers_on_known_records(monkeypatch, capsys):
    if REPO not in sys.path:
        monkeypatch.syspath_prepend(REPO)
    # two likelihood calls in one step: 100 ms each, of which trajectory 60
    # and 50, amplitudes 10, level-1 5 (overlapping a trajectory by 0 ms),
    # dense 1, splines 4 and 6 (not covered); a gc pause in the second
    spans = [
        _span("sampler.step", 1, None, 1, 0, 300),
        _span("likelihood.call", 2, 1, 1, 10, 110),
        _span("waveform.prologue", 3, 2, 1, 10, 80),
        _span("trajectory.dp5", 4, 3, 1, 10, 70, **{"dp5.trips": 100, "dp5.lane_slots": 6400,
                                                    "dp5.accepted": 5760, "dp5.rejected": 100}),
        _span("amplitudes", 5, 3, 1, 70, 80),
        _span("core.level1", 6, 2, 1, 85, 90),
        _span("core.dense", 7, 2, 1, 90, 91),
        _span("likelihood.call", 8, 1, 1, 150, 250),
        _span("waveform.prologue", 9, 8, 1, 150, 210),
        _span("trajectory.dp5", 10, 9, 1, 150, 200, **{"dp5.trips": 80, "dp5.lane_slots": 5120,
                                                       "dp5.accepted": 4800, "dp5.rejected": 50}),
        _span("amplitudes", 11, 9, 1, 200, 210),
        _span("host.gc", 12, 8, 1, 220, 230),
        _span("core.prepare", 13, 2, 1, 80, 84),
        _span("core.prepare", 14, 8, 1, 210, 216),
    ]
    totals = {"dp5.trips": 180, "dp5.lane_slots": 11520, "dp5.accepted": 10560,
              "dp5.rejected": 150}
    monkeypatch.setattr(tracing, "records", lambda: list(spans))
    monkeypatch.setattr(tracing, "totals", lambda: dict(totals))
    gaps = [(int(225e6), int(226e6)), (int(120e6), int(140e6)), (int(30e6), int(31e6))]
    run = types.SimpleNamespace(devtrace=types.SimpleNamespace(gaps=gaps))
    assert _reader("dp5_trips_per_call")(run) == pytest.approx(90.0)
    assert _reader("dp5_lane_use_pct")(run) == pytest.approx(100 * 10560 / 11520)
    assert _reader("dp5_trip_ms")(run) == pytest.approx(110.0 / 180)
    # call 1: 100 - (60 + 10 + 5 + 1) = 24; call 2: 100 - (50 + 10) = 40
    assert _reader("host_rest_ms")(run) == pytest.approx(32.0)
    assert _reader("splines_ms")(run) == pytest.approx(5.0)
    err = capsys.readouterr().err
    assert err.count("[trace] program spans (2 calls; ms)") == 1
    assert ("[trace] idle gaps by program span: 1.000 ms sampler.step>likelihood.call>host.gc; "
            "20.000 ms sampler.step; 1.000 ms sampler.step>likelihood.call>waveform.prologue>"
            "trajectory.dp5") in err
    # nothing recorded (an untraced run), or no tracer (an older program)
    monkeypatch.setattr(tracing, "records", lambda: [])
    for name in ("dp5_trips_per_call", "dp5_lane_use_pct", "dp5_trip_ms", "host_rest_ms",
                 "splines_ms"):
        assert _reader(name)(types.SimpleNamespace(devtrace=None)) is None
    import emri_frequencydomainwaveforms_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "emri_frequencydomainwaveforms_tpu_torch.utils.tracing", None)
    assert _reader("host_rest_ms")(types.SimpleNamespace(devtrace=None)) is None
