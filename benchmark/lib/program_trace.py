"""The program's own spans and counters in a traced run
(`emri_frequencydomainwaveforms_tpu_torch.utils.tracing`).

The program records while a `torch.profiler` session runs, and the only
session of a traced run is its one profiled step, so the records cover
exactly that step. A "call" is one `waveform.prologue` span: a likelihood
call of ``subset`` rows in a PE cell, one batch in a waveform cell.

`read(run)` returns the records (a `ProgramTrace`), or None where the
program has no tracer or recorded nothing (an untraced run, the CPU). Its
first call in a run also logs to standard error a ``[trace] program spans``
line (each span name's count, host ms, self ms and counters, then the
totals) and a ``[trace] idle gaps`` line: each of the device trace's longest
idle gaps beside the innermost program span open at its middle, as a path
from the root, or "no root span" where none is open (harness work between
calls).
"""

from __future__ import annotations

import sys

ROOTS = ("likelihood.call", "waveform.batch")
# the layers that an outside metric already times; host_rest_ms is the rest
COVERED = ("trajectory.dp5", "trajectory.quad", "amplitudes", "core.level1", "core.dense")


class ProgramTrace:
    """``spans``: the program's closed spans (`tracing.Span`); ``totals``:
    its counters; ``calls``: the prologue spans."""

    def __init__(self, spans, totals):
        self.spans = list(spans)
        self.totals = dict(totals)
        self.by_id = {s.id: s for s in self.spans}
        self.calls = sum(1 for s in self.spans if s.name == "waveform.prologue")

    def ms(self, name: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) * 1e-6

    def path(self, s) -> str:
        names = [s.name]
        while s.parent is not None and s.parent in self.by_id:
            s = self.by_id[s.parent]
            names.append(s.name)
        return ">".join(reversed(names))

    def innermost(self, t_ns: int):
        """The shortest span open at ``t_ns`` (None if none)."""
        best = None
        for s in self.spans:
            if s.start_ns <= t_ns < s.end_ns and (
                    best is None or s.end_ns - s.start_ns < best.end_ns - best.start_ns):
                best = s
        return best

    def rest_ms(self) -> float | None:
        """Host ms inside the root spans (`ROOTS`) that no `COVERED` span of
        the same call covers (None without a root span)."""
        roots = [s for s in self.spans if s.name in ROOTS]
        if not roots:
            return None
        total = 0
        for root in roots:
            inner = sorted((s.start_ns, s.end_ns) for s in self.spans
                           if s.name in COVERED and s.call == root.call
                           and root.start_ns <= s.start_ns and s.end_ns <= root.end_ns)
            covered, end = 0, root.start_ns
            for a, b in inner:
                a = max(a, end)
                if b > a:
                    covered += b - a
                    end = b
            total += (root.end_ns - root.start_ns) - covered
        return total * 1e-6

    def summary(self) -> dict:
        """{name: [count, host ms, self ms, {counter: sum}]}."""
        child_ns: dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
        out: dict[str, list] = {}
        for s in self.spans:
            rec = out.setdefault(s.name, [0, 0.0, 0.0, {}])
            rec[0] += 1
            rec[1] += (s.end_ns - s.start_ns) * 1e-6
            rec[2] += (s.end_ns - s.start_ns - child_ns.get(s.id, 0)) * 1e-6
            for k, v in s.counters.items():
                rec[3][k] = rec[3].get(k, 0) + v
        return out


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _load():
    try:
        from emri_frequencydomainwaveforms_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.records()
    if not spans:
        return None
    return ProgramTrace(spans, tracing.totals())


def read(run):
    """The run's `ProgramTrace` (None without one), logged once a run."""
    if hasattr(run, "program_trace"):
        return run.program_trace
    pt = _load()
    run.program_trace = pt
    if pt is None:
        return None
    parts = [f"{name} n={n} host={ms:.3f} self={own:.3f}" + (f" {counters}" if counters else "")
             for name, (n, ms, own, counters) in sorted(pt.summary().items(),
                                                        key=lambda kv: -kv[1][1])]
    _log(f"[trace] program spans ({pt.calls} calls; ms): " + "; ".join(parts)
         + f"; totals {pt.totals}")
    dt = getattr(run, "devtrace", None)
    if dt is not None and dt.gaps:
        named = []
        for a, b in dt.gaps:
            s = pt.innermost((a + b) // 2)
            named.append(f"{(b - a) * 1e-6:.3f} ms {pt.path(s) if s else 'no root span'}")
        _log("[trace] idle gaps by program span: " + "; ".join(named))
    return pt


def per_call(run, value_of):
    """``value_of(trace)`` / the calls (None where either is missing)."""
    pt = read(run)
    if pt is None or not pt.calls:
        return None
    value = value_of(pt)
    return None if value is None else value / pt.calls
