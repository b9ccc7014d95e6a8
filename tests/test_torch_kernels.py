"""The port's dense-pass kernel wrapper, without JAX.

This file imports no JAX, so it also runs on the GPU machine (which has
none), with the suite's JAX-configuring conftest switched off:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

* the plain version against a float64 per-bin NumPy loop of the same
  formula (overlapping windows, a dead slot, NaN in masked lanes, two slot
  groups): float32 level;
* dispatch: CPU tensors take the plain version, other devices raise;
* the CUDA kernel against the plain version on the card (marked ``cuda``;
  skips without a card).
"""

import math

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense as t_dense


def _synthetic_groups(rng, n_b, slots, r, nf, nan_masked=True):
    """Random dense-pass tables: overlapping windows, a dead slot, band
    edges inside runs and (optionally) NaN coefficients in masked lanes.
    ``slots`` is a list of (n_slots, g_band) per group."""
    groups = []
    g_total = -(-nf // r)
    for n_s, g_band in slots:
        pc = rng.uniform(-3.0, 3.0, (n_b, n_s, g_band, 4)).astype(np.float32)
        nc = rng.integers(-2000, 2000, (n_b, n_s, g_band, 3)).astype(np.int32)
        ec = rng.uniform(-1.0, 1.0, (n_b, n_s, g_band, 8)).astype(np.float32)
        g0 = rng.integers(0, max(g_total - g_band // 2, 1), (n_b, n_s)).astype(np.int32)
        g0[:, 1:2] = g0[:, :1]  # two slots on the same window
        i_lo = rng.integers(r, g_band * r // 3, (n_b, n_s)).astype(np.int32)
        i_hi = (i_lo + rng.integers(r, g_band * r, (n_b, n_s))).astype(np.int32)
        i_lo[:, -1] = 2**31 - 1  # dead slot
        if nan_masked:
            pc[:, :, 0, :] = np.nan  # run 0 ends below every i_lo
            ec[:, :, 0, 5] = np.nan
        w = rng.standard_normal((n_b, n_s, 4)).astype(np.float32)
        groups.append(t_dense.DenseGroup(
            *(torch.from_numpy(x) for x in (pc, nc, ec, i_lo, i_hi, w, g0))
        ))
    return groups


def _numpy_dense(groups, r, nf):
    """float64 per-(slot, bin) loop of the dense-pass formula."""
    n_b = groups[0].pc.shape[0]
    out = np.zeros((n_b, 4, nf))
    for grp in groups:
        pc, nc, ec, i_lo, i_hi, w, g0 = (x.numpy() for x in grp)
        n_s, n_g = pc.shape[1], pc.shape[2]
        for b in range(n_b):
            for s in range(n_s):
                for local in range(max(i_lo[b, s], 0), min(i_hi[b, s], n_g * r - 1) + 1):
                    i = g0[b, s] * r + local
                    if i >= nf:
                        break
                    g, k = divmod(local, r)
                    xi = k / r
                    p = pc[b, s, g].astype(np.float64)
                    n1, n2, n3 = (int(v) for v in nc[b, s, g])
                    e = ec[b, s, g].astype(np.float64)
                    cyc = (n1 * k * r * r + n2 * k * k * r + n3 * k**3) % (r**3)
                    psi = (p[0] + xi * (p[1] + xi * (p[2] + xi * p[3]))
                           + 2 * math.pi * cyc / r**3
                           + e[4] + xi * (e[5] + xi * (e[6] + xi * e[7])))
                    amp = e[0] + xi * (e[1] + xi * (e[2] + xi * e[3]))
                    c = amp * complex(math.cos(psi), math.sin(psi))
                    w1 = complex(w[b, s, 0], w[b, s, 1]) * c
                    w2 = complex(w[b, s, 2], w[b, s, 3]) * c
                    out[b, :, i] += (w1.real, w1.imag, w2.real, w2.imag)
    return out


def test_plain_version_matches_numpy_loop():
    rng = np.random.default_rng(44)
    r, nf = 8, 900
    groups = _synthetic_groups(rng, 2, [(4, 16), (2, 4)], r, nf)
    got = t_dense.fd_dense_accumulate_reference(groups, r=r, nf=nf).numpy()
    ref = _numpy_dense(groups, r, nf)
    assert np.all(np.isfinite(got))
    # float32 evaluation of O(10)-rad phases: ~1e-6 rad
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


def test_dispatch_cpu_uses_plain_version_and_other_devices_raise():
    rng = np.random.default_rng(42)
    groups = _synthetic_groups(rng, 2, [(4, 16), (2, 4)], 8, 700)
    before = t_dense.fd_dense_accumulate.launches
    out = t_dense.fd_dense_accumulate(groups, r=8, nf=700)
    assert t_dense.fd_dense_accumulate.launches == before
    assert torch.equal(out, t_dense.fd_dense_accumulate_reference(groups, r=8, nf=700))
    assert torch.all(torch.isfinite(out))
    meta = [t_dense.DenseGroup(*(x.to("meta") for x in g)) for g in groups]
    with pytest.raises(ValueError):
        t_dense.fd_dense_accumulate(meta, r=8, nf=700)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(43)
    r, nf = 64, 300_001
    groups = [
        t_dense.DenseGroup(*(x.cuda() for x in g))
        for g in _synthetic_groups(rng, 3, [(6, 256), (2, 64)], r, nf)
    ]
    before = t_dense.fd_dense_accumulate.launches
    got = t_dense.fd_dense_accumulate(groups, r=r, nf=nf)
    torch.cuda.synchronize()
    assert t_dense.fd_dense_accumulate.launches == before + 1
    ref = t_dense.fd_dense_accumulate_reference(groups, r=r, nf=nf)
    assert torch.all(torch.isfinite(got))
    # same summation order; only sin/cos ulps and FMA contraction differ
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    # the main group alone, and a batch of one walker (the unbatched Pallas
    # kernel's shape)
    for case in (groups[:1], [t_dense.DenseGroup(*(x[:1].contiguous() for x in g)) for g in groups]):
        got = t_dense.fd_dense_accumulate(case, r=r, nf=nf)
        ref = t_dense.fd_dense_accumulate_reference(case, r=r, nf=nf)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    bad = groups[0]._replace(pc=groups[0].pc.double())
    with pytest.raises(ValueError):
        t_dense.fd_dense_accumulate([bad], r=r, nf=nf)
