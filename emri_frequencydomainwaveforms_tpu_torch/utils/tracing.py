"""Spans and counters of the port's layers, kept in memory.

A span names a stretch of host time in one layer (``waveform.prologue``,
``trajectory.dp5``, ``core.level1``, ...); a counter adds a number to the
innermost open span and to the totals (``dp5.trips``,
``fd_dense.launches``, ...). Both record only while tracing is active:
inside ``with tracing.enabled():``, or while a `torch.profiler` session
runs, so that a profiled region gets the program's spans with no option of
its own.

Off, a span costs one function call and one flag test, a counter records
nothing, and neither adds a launch, a synchronize or a host read. On, a
span does not synchronize either: its times are host times, taken with
`time.time_ns`, the clock of the profiler's events, so a gap in a device
trace can be named by the span open on the host at that moment. No span
opens a ``record_function`` range (the profiler would show it as device
activity).

Each record (`Span`) holds its name, its id, its parent's id (None at a
root), the id of its root (``call``: shared by every span under one root),
its start and end in nanoseconds and the counters added while it was the
innermost open span. The buffer keeps at most `MAX_SPANS` records; past
that it counts the spans it drops (``tracing.dropped_spans`` in the
totals). Collections of Python's garbage collector are recorded as
``host.gc`` spans, with the objects collected in ``gc.collected``.

    with tracing.enabled():
        out = fn(...)
    for s in tracing.records(): ...
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 20

_profiler_enabled = torch._C._autograd._profiler_enabled
_depth = 0  # nesting of `enabled`
_records: list = []
_totals: dict[str, int] = {}
_ids = [0]
_local = threading.local()


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    counters: dict


def active() -> bool:
    """True inside `enabled` or while a `torch.profiler` session runs."""
    return bool(_depth) or _profiler_enabled()


@contextlib.contextmanager
def enabled():
    """Record spans and counters over the ``with`` body."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """An open span: pushed on entry, recorded on exit."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "counters")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        _ids[0] += 1
        self.id = _ids[0]
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        self.counters = {}
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().remove(self)
        if len(_records) < MAX_SPANS:
            _records.append(Span(self.name, self.id, self.parent, self.call, self.start_ns, end,
                                 self.counters))
        else:
            _totals["tracing.dropped_spans"] = _totals.get("tracing.dropped_spans", 0) + 1
        return False


_CLOSED = contextlib.nullcontext()


def span(name: str):
    """Context manager: a span ``name`` around the body (nothing when off)."""
    if not (_depth or _profiler_enabled()):
        return _CLOSED
    return _Open(name)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_depth or _profiler_enabled()):
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` on the innermost open span and to the
    totals (nothing when off)."""
    if not (_depth or _profiler_enabled()):
        return
    _totals[name] = _totals.get(name, 0) + n
    stack = _stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


def records() -> list[Span]:
    """The closed spans recorded since the last `reset`, in closing order."""
    return list(_records)


def totals() -> dict[str, int]:
    """Every counter summed since the last `reset`."""
    return dict(_totals)


def reset() -> None:
    """Clear the records and the totals (open spans stay open)."""
    _records.clear()
    _totals.clear()


_gc_open: list = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if _depth or _profiler_enabled():
            s = _Open("host.gc")
            s.__enter__()
            _gc_open.append(s)
    elif _gc_open:
        count("gc.collected", info.get("collected", 0))
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)


__all__ = ["MAX_SPANS", "Span", "active", "enabled", "span", "spanned", "count", "records",
           "totals", "reset"]
