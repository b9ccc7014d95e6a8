"""Milliseconds of mode_amplitudes (the call waveform_prologue makes) per
likelihood call or per batch (synchronized spans)."""

from benchmark.lib import readers


def read(run):
    return readers.ms_per_call(run, "amplitudes")
