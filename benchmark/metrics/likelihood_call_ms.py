"""Median synchronized wall of one Likelihood.__call__, milliseconds."""

import statistics

from benchmark.lib import readers


def read(run):
    s = readers.seconds(run, "likelihood")
    return 1e3 * statistics.median(s) if s else None
