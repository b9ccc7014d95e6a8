"""Milliseconds a sampler step spends outside its likelihood calls (the
moves, tempering and bookkeeping on the host), per step."""

from benchmark.lib import readers


def read(run):
    steps = readers.seconds(run, "step")
    if not steps:
        return None
    return 1e3 * (sum(steps) - sum(readers.seconds(run, "likelihood"))) / len(steps)
