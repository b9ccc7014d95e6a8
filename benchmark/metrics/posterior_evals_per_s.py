"""Posterior evaluations per second: ntemps x nwalkers x whole sampler steps
completed, over the wall of those steps (host clock, synchronized)."""


def read(run):
    return run.units / run.wall_s if run.driver == "pe_sampler" else None
