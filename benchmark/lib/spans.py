"""Host spans around the program's layer entry calls, recorded from the
benchmark's own files (after ``chip_smoke.py``'s ``StageTimer`` and
``patched``).

A span synchronizes the device before and after its call, so its length is
the layer's whole time, device work included. Spans are only recorded in a
traced run (``--trace 1``); the end-to-end metrics come from untraced runs.
Each span keeps its wall-clock start and end in nanoseconds, the clock of
the profiler's events, so that an idle gap of the device trace can be named
by the span open on the host.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def patched(module, name, fn):
    """Replace ``module.name`` by ``fn`` for the duration."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


class Spans:
    """Named, synchronized host spans: ``records[name]`` is a list of
    (start ns, end ns). ``sync`` waits for the device (a no-op on the CPU)."""

    def __init__(self, sync):
        self.sync = sync
        self.records: dict[str, list[tuple[int, int]]] = {}

    def wrap(self, name, fn):
        """``fn`` whose every call is recorded as a span ``name``."""
        def run(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return run

    @contextlib.contextmanager
    def span(self, name):
        self.sync()
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.records.setdefault(name, []).append((t0, time.time_ns()))

    def seconds(self, name) -> list[float]:
        return [(b - a) * 1e-9 for a, b in self.records.get(name, [])]

    def innermost(self, t_ns: int) -> str:
        """The name of the shortest span open at ``t_ns`` ("none" if none)."""
        best, best_len = "none", None
        for name, recs in self.records.items():
            for a, b in recs:
                if a <= t_ns < b and (best_len is None or b - a < best_len):
                    best, best_len = name, b - a
        return best
