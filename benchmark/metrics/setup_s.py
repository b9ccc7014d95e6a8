"""Seconds from the process start to the first timed step or batch."""


def read(run):
    return run.setup_s
