"""The dense pass's share of its roofline, %: the frozen bound of the tables
each launch of the profiled step got, over the kernel's device time."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "fd_dense", "fd_dense_kernel")
