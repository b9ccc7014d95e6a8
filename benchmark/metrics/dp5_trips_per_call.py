"""Trips of the dp5 loop per call (the program's ``dp5.trips`` counter over
its prologue spans in the profiled step): each trip is one host read of the
loop's condition and six RHS evaluations of the whole batch."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.per_call(run, lambda pt: pt.totals.get("dp5.trips"))
