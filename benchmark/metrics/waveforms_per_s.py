"""Waveforms per second: B x whole batches completed, over the wall of those
batches (host clock, synchronized)."""


def read(run):
    return run.units / run.wall_s if run.driver == "wf_batch" else None
