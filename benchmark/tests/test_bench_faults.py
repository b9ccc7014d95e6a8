"""The timed path broken underneath: ``correct`` comes out false, once for
each fault a cell can have (one chip: no exchange between chips)."""

import contextlib

import pytest

from conftest import run_tiny


@contextlib.contextmanager
def dense_fault(kind):
    """Break the FD core's dense pass, where the spectra are produced."""
    from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd

    real = summation_fd.fd_dense_accumulate
    first = []

    def broken(groups, *, r, nf):
        out = real(groups, r=r, nf=nf)
        if kind == "half":  # half of the batch left out, the mean of the rest in its place
            half = out.shape[0] // 2
            out = out.clone()
            out[half:] = out[:half].mean(dim=0, keepdim=True)
        elif kind == "altered":
            out = out * 1.5
        elif kind == "stale":  # every call returns the first call's answer
            if not first:
                first.append(out.clone())
            out = first[0] if first[0].shape == out.shape else out
        return out

    summation_fd.fd_dense_accumulate = broken
    try:
        yield
    finally:
        summation_fd.fd_dense_accumulate = real


@contextlib.contextmanager
def sampler_stuck():
    """Each sampler step evaluates its proposals but returns its state
    unchanged."""
    from emri_frequencydomainwaveforms_tpu_torch.inference.ensemble import EnsembleSampler

    real = EnsembleSampler._step

    def stuck(self, coords, log_like, log_prior, betas, seed, iteration, move_info=None):
        out = real(self, coords, log_like, log_prior, betas, seed, iteration, move_info)
        return (coords, log_like, log_prior, betas) + out[4:]

    EnsembleSampler._step = stuck
    try:
        yield
    finally:
        EnsembleSampler._step = real


@contextlib.contextmanager
def wrong_move():
    """The stretch move draws its factors z from the wrong law (z = ((a - 1)
    U + 1) / a): proposals and log L stay consistent with each other."""
    from emri_frequencydomainwaveforms_tpu_torch.inference.moves import stretch

    real = stretch.StretchMove.draws

    def draws(self, generator, shape):
        return [(((self.a - 1.0) * z.sqrt() * self.a ** 0.5 - 1.0) / self.a + 1.0 / self.a, p, u)
                for z, p, u in real(self, generator, shape)]

    stretch.StretchMove.draws = draws
    try:
        yield
    finally:
        stretch.StretchMove.draws = real


@contextlib.contextmanager
def loglike_altered():
    """Every log L the likelihood returns is off by a relative 1e-6."""
    from emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood import Likelihood

    real = Likelihood.__call__

    def altered(self, params, **kw):
        return real(self, params, **kw) * (1.0 + 1e-6)

    Likelihood.__call__ = altered
    try:
        yield
    finally:
        Likelihood.__call__ = real


FAULTS = {"stuck": sampler_stuck, "wrong_move": wrong_move, "loglike": loglike_altered}


@contextlib.contextmanager
def wrong_move():
    """The stretch move draws its factors from the wrong law, z uniform in
    [1/a, a] in place of ((a - 1) U + 1)^2 / a: proposals and log L stay
    consistent with each other."""
    from emri_frequencydomainwaveforms_tpu_torch.inference.moves import stretch

    real = stretch.StretchMove.draws

    def draws(self, generator, shape):
        a = self.a
        return [(1.0 / a + (a - 1.0 / a) * (((z * a) ** 0.5 - 1.0) / (a - 1.0)), p, u)
                for z, p, u in real(self, generator, shape)]

    stretch.StretchMove.draws = draws
    try:
        yield
    finally:
        stretch.StretchMove.draws = real


@contextlib.contextmanager
def loglike_altered():
    """Every log L the likelihood returns is off by a relative 1e-6."""
    from emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood import Likelihood

    real = Likelihood.__call__

    def altered(self, params, **kw):
        return real(self, params, **kw) * (1.0 + 1e-6)

    Likelihood.__call__ = altered
    try:
        yield
    finally:
        Likelihood.__call__ = real


FAULTS = {"stuck": sampler_stuck, "wrong_move": wrong_move, "loglike": loglike_altered}


@pytest.mark.parametrize("workload,fault", [
    ("wf_tiny.dp5_b4", "half"), ("wf_tiny.dp5_b4", "altered"), ("wf_tiny.dp5_b4", "stale"),
    ("wf_tiny.quad_b4", "half"), ("wf_tiny.quad_b4", "altered"), ("wf_tiny.quad_b4", "stale"),
    ("pe_tiny.t2w4", "half"), ("pe_tiny.t2w4", "altered"), ("pe_tiny.t2w4", "stuck"),
    ("pe_tiny.t2w4", "wrong_move"), ("pe_tiny.t2w4", "loglike"),
])
def test_fault_makes_the_run_incorrect(tiny_root, workload, fault):
    cm = FAULTS[fault]() if fault in FAULTS else dense_fault(fault)
    res = run_tiny(tiny_root, workload, seconds=3.0, faults=cm)
    assert not res["correct"], res["checks"]
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed
    if fault == "stuck":
        assert {"unmoved_share", "move_replay_mismatch"} <= set(failed)
    if fault == "wrong_move":
        assert failed == ["move_replay_mismatch"]
    if fault == "loglike":
        assert "loglike_consistency" in failed
