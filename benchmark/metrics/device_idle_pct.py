"""The device's idle share of the profiled step, %: 1 - the union of its
operations' intervals over the step's wall."""


def read(run):
    dt = run.devtrace
    if dt is None or dt.window_s <= 0 or dt.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
