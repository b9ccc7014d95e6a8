"""The running-sum kernel's share of its roofline, %: its input read once and
its output written once at the HBM peak, over the kernel's device time, for
the launches of the profiled step."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "row_cumsum", "row_cumsum_kernel")
