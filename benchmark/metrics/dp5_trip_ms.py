"""Host milliseconds per trip of the dp5 loop: the program's
``trajectory.dp5`` spans over its ``dp5.trips`` counter, in the profiled
step (so with the profiler's cost per launch: compare between commits,
never with untraced walls)."""

from benchmark.lib import program_trace


def read(run):
    pt = program_trace.read(run)
    if pt is None or not pt.totals.get("dp5.trips"):
        return None
    return pt.ms("trajectory.dp5") / pt.totals["dp5.trips"]
