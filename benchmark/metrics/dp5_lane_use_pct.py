"""The dp5 loop's lane use, %: 100 x the accepted steps over the lane slots
(batch size x trips) of the profiled step (the program's ``dp5.accepted``
and ``dp5.lane_slots`` counters). The rest of the slots are rejected steps
and finished lanes waiting for the slowest."""

from benchmark.lib import program_trace


def read(run):
    pt = program_trace.read(run)
    if pt is None or not pt.totals.get("dp5.lane_slots"):
        return None
    return 100.0 * pt.totals.get("dp5.accepted", 0) / pt.totals["dp5.lane_slots"]
