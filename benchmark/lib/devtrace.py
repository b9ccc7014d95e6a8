"""The device trace of a traced run's profiled region (``torch.profiler``,
CUDA activity only; the sound method of ``chip_smoke.py::device_trace``).

The events are read from the profiler's raw results, not through
``key_averages`` (which builds a Python object per event: too slow at the
10^5 launches of one trajectory). The summary: the device's busy seconds
(the union of its operations' intervals), the region's wall seconds, each
operation name's count and seconds, the kernel launches, and the longest
idle gaps between operations.
"""

from __future__ import annotations

import contextlib
import time


class DeviceTrace:
    """Filled by `profiled`: ``window_s``, ``busy_s``, ``ops`` {name: [count,
    seconds]}, ``launches`` (kernels, not copies or fills), ``gaps``
    [(start ns, end ns)] longest first (at most ``max_gaps``)."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: dict[str, list] = {}
        self.launches = 0
        self.gaps: list[tuple[int, int]] = []

    def seconds_of(self, fragment: str) -> tuple[int, float]:
        """(count, seconds) summed over the operations whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.ops.items():
            if fragment in name:
                n, s = n + c, s + sec
        return n, s


def _summarize(out: DeviceTrace, events, t0_ns: int, t1_ns: int, max_gaps: int) -> None:
    intervals = []
    for e in events:
        if "cuda" not in str(e.device_type()).lower():
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        rec = out.ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            out.launches += 1
        intervals.append((a, b))
    intervals.sort()
    busy, gaps = 0, []
    cur_a = cur_b = None
    prev_end = t0_ns
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gaps.append((prev_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        prev_end = cur_b
    if cur_b is not None:
        busy += cur_b - cur_a
    gaps.append((prev_end, t1_ns))
    out.busy_s = busy * 1e-9
    gaps = [g for g in gaps if g[1] > g[0]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out.gaps = gaps[:max_gaps]


@contextlib.contextmanager
def profiled(out: DeviceTrace, sync, max_gaps: int = 10):
    """Profile the device over the ``with`` body and fill ``out``."""
    import torch

    act = torch.profiler.ProfilerActivity
    sync()
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        t0 = time.time_ns()
        yield out
        sync()
        t1 = time.time_ns()
    out.window_s = (t1 - t0) * 1e-9
    _summarize(out, prof.profiler.kineto_results.events(), t0, t1, max_gaps)
