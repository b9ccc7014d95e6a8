"""Peak device memory of the window, GiB: torch.cuda.max_memory_allocated
with the counter reset after set-up, less the buffer in which the harness
keeps sampled outputs for the comparison (allocated in set-up, constant)."""


def read(run):
    return None if run.peak_window_bytes is None else run.peak_window_bytes / 2**30
