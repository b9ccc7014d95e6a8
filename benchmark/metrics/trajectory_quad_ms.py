"""Milliseconds of the quadrature trajectory (the call waveform_prologue makes) per
likelihood call or per batch (synchronized spans)."""

from benchmark.lib import readers


def read(run):
    return readers.ms_per_call(run, "trajectory_quad")
