"""Host milliseconds per call in the program's ``core.prepare`` spans
(`prepare_fd_inputs`: the splines of the knots and the per-slot tables), in
the profiled step: the largest part of ``host_rest_ms``."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.per_call(
        run, lambda pt: pt.ms("core.prepare") if "core.prepare" in pt.summary() else None)
