"""CUDA kernel launches in the profiled step per waveform it completed."""


def read(run):
    dt = run.devtrace
    if dt is None or not run.units_profiled or not dt.launches:
        return None
    return dt.launches / run.units_profiled
