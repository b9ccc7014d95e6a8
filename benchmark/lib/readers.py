"""What the metric readers share: span seconds over the window's unprofiled
steps, per call of the layer that a step repeats."""

from __future__ import annotations


def records(run, name: str) -> list[tuple[int, int]]:
    """Span ``name``'s records, leaving out the first step where there are
    more (the device was profiled over it, which slows the host)."""
    if run.spans is None:
        return []
    recs = run.spans.records.get(name, [])
    steps = run.spans.records.get("step", [])
    if len(steps) > 1:
        first_end = steps[0][1]
        recs = [r for r in recs if r[0] >= first_end]
    return recs


def seconds(run, name: str) -> list[float]:
    return [(b - a) * 1e-9 for a, b in records(run, name)]


def calls(run) -> int:
    """The calls a step repeats: likelihood calls (PE), batches (waveforms)."""
    return len(records(run, "likelihood" if run.driver == "pe_sampler" else "step"))


def ms_per_call(run, name: str):
    """Milliseconds of span ``name`` per call (None without such spans)."""
    s, n = seconds(run, name), calls(run)
    return 1e3 * sum(s) / n if s and n else None


def roofline_pct(run, bound_key: str, kernel: str):
    """100 x the launches' bound seconds over their device seconds in the
    profiled step (None without a device trace, without a launch, or where
    the trace's launches and the recorded inputs do not pair up)."""
    dt, bounds = run.devtrace, run.bounds.get(bound_key, [])
    if dt is None or not bounds:
        return None
    n, dev_s = dt.seconds_of(kernel)
    if n != len(bounds) or dev_s <= 0:
        return None
    return 100.0 * sum(bounds) / dev_s
