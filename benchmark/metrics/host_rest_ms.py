"""Host milliseconds per call inside the program's root span of a call
(``likelihood.call`` or ``waveform.batch``) that none of its
``trajectory.*``, ``amplitudes``, ``core.level1`` and ``core.dense`` spans
covers, in the profiled step: the time no other per-layer metric names."""

from benchmark.lib import program_trace


def read(run):
    return program_trace.per_call(run, lambda pt: pt.rest_ms())
