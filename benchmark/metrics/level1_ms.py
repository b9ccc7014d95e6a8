"""Milliseconds of the level-1 node tables (fd_mode_sum_uniform's walker chunks) per
likelihood call or per batch (synchronized spans)."""

from benchmark.lib import readers


def read(run):
    return readers.ms_per_call(run, "level1")
