"""The port's dense-pass kernel wrapper, without JAX.

This file imports no JAX, so it also runs on the GPU machine (which has
none), with the suite's JAX-configuring conftest switched off:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

* the plain version against a float64 per-bin NumPy loop of the same
  formula (overlapping windows, a dead slot, NaN in masked lanes, two slot
  groups), and on each adversarial layout of ``testing/fd_dense_cases.py``
  (run sizes 1..128, ragged grid ends, windows across and past the grid
  end, band edges inside a 4-bin vector, all slots dead): float32 level,
  and exactly 0 outside every kept band;
* the kept-band counts the smoke's bound uses, against a per-bin loop;
* dispatch: CPU tensors take the plain version, other devices raise;
* the kernel's call checks, which refuse pc, ec or w not 16-byte aligned;
* the kernel's padded output rows: the (B, 4, nf) view and its strides;
* the CUDA kernel against the plain version on the card, at a main-path-like
  shape, B = 1 and every adversarial layout (marked ``cuda``; skips without
  a card).
"""

import math

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense as t_dense
from emri_frequencydomainwaveforms_tpu_torch.testing import fd_dense_cases as cases

_CASES = {c.name: c for c in cases.adversarial_cases(np.random.default_rng(45))}


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
    groups = cases.random_groups(rng, 2, [(4, 16), (2, 4)], r, nf)
    got = t_dense.fd_dense_accumulate_reference(groups, r=r, nf=nf).numpy()
    ref = _numpy_dense(groups, r, nf)
    assert np.all(np.isfinite(got))
    # float32 evaluation of O(10)-rad phases: ~1e-6 rad
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("name", sorted(_CASES))
def test_plain_version_on_adversarial_layouts(name):
    case = _CASES[name]
    got = t_dense.fd_dense_accumulate_reference(case.groups, r=case.r, nf=case.nf)
    assert got.shape == (case.groups[0].pc.shape[0], 4, case.nf)
    assert torch.all(torch.isfinite(got))
    kept = cases.kept_mask(case.groups, case.r, case.nf)[:, None, :].expand_as(got)
    assert torch.all(got[~kept] == 0)
    ref = _numpy_dense(case.groups, case.r, case.nf)
    scale = np.max(np.abs(ref))
    if name == "all_dead":
        assert scale == 0 and not kept.any()
        return
    assert np.max(np.abs(got.numpy() - ref)) / scale < 1e-5


@pytest.mark.parametrize("name", sorted(_CASES))
def test_kept_counts_match_a_per_bin_loop(name):
    case = _CASES[name]
    pairs, cells = 0, set()
    for k, grp in enumerate(case.groups):
        n_g = grp.pc.shape[2]
        for b in range(grp.pc.shape[0]):
            for s in range(grp.pc.shape[1]):
                lo, hi = int(grp.i_lo[b, s]), int(grp.i_hi[b, s])
                for local in range(max(lo, 0), min(hi, n_g * case.r - 1) + 1):
                    if int(grp.g0[b, s]) * case.r + local >= case.nf:
                        break
                    pairs += 1
                    cells.add((k, b, s, local // case.r))
    assert cases.kept_pairs(case.groups, case.r, case.nf) == pairs
    assert cases.kept_runs(case.groups, case.r, case.nf) == len(cells)
    assert int(cases.kept_mask(case.groups, case.r, case.nf).sum()) <= pairs


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past an aligned
    address."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("field", ["pc", "ec", "w"])
def test_kernel_call_refuses_vector_reads_off_16_bytes(field):
    groups = cases.random_groups(np.random.default_rng(46), 2, [(4, 16), (2, 4)], 8, 700)
    t_dense.check_call(groups, r=8, nf=700)
    bad = _misaligned(getattr(groups[1], field))
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        t_dense.check_call([groups[0], groups[1]._replace(**{field: bad})], r=8, nf=700)


@pytest.mark.parametrize("nf", [1, 31, 32, 33, 1_577_907])
def test_output_buffer_rows(nf):
    buf, out = t_dense.output_buffer(3, nf, "meta")
    nf_pad = t_dense.padded_bins(nf)
    assert nf_pad % 32 == 0 and nf <= nf_pad < nf + 32
    assert buf.shape == (3, 4, nf_pad) and buf.is_contiguous()
    assert out.shape == (3, 4, nf) and out.stride() == (4 * nf_pad, nf_pad, 1)
    assert out[:, 2].shape == (3, nf) and out[:, 2].stride() == (4 * nf_pad, 1)


def test_dispatch_cpu_uses_plain_version_and_other_devices_raise():
    rng = np.random.default_rng(42)
    groups = cases.random_groups(rng, 2, [(4, 16), (2, 4)], 8, 700)
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
        for g in cases.random_groups(rng, 3, [(6, 256), (2, 64)], r, nf)
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
    # a contiguous view off 16 bytes raises before the launch, not in it
    flat = torch.empty(groups[0].ec.numel() + 1, device="cuda")
    bad = groups[0]._replace(ec=flat[1:].view(groups[0].ec.shape).copy_(groups[0].ec))
    with pytest.raises(ValueError, match="aligned"):
        t_dense.fd_dense_accumulate([bad], r=r, nf=nf)
    # the adversarial layouts: same tolerance, exact zeros outside every band
    for case in _CASES.values():
        grps = [t_dense.DenseGroup(*(x.cuda() for x in g)) for g in case.groups]
        got = t_dense.fd_dense_accumulate(grps, r=case.r, nf=case.nf)
        ref = t_dense.fd_dense_accumulate_reference(grps, r=case.r, nf=case.nf)
        assert got.shape == ref.shape and torch.all(torch.isfinite(got)), case.name
        kept = cases.kept_mask(grps, case.r, case.nf)[:, None, :].expand_as(got)
        assert torch.all(got[~kept] == 0), case.name
        scale = float(ref.abs().max())
        if case.name == "all_dead":
            assert scale == 0, case.name
        else:
            assert float((got - ref).abs().max()) / scale <= 1e-5, case.name
