"""The port's Pallas-named FD entry points against the JAX package.

`fd_mode_sum_uniform_pallas[_batched]` at the configuration of
tests/test_waveform.py::TestPallasKernel (a 0.05-yr source, the l <= 6
table with eps selection, 16 slots, a 20000-bin uniform grid in runs of 8
bins, 2048-run windows). On the CPU the wrapper's dense pass is the plain
version of the CUDA kernel.

Tolerances: against the reference's interpret-mode Pallas kernel and
against its XLA banded kernel, max/scale < 1e-4 per channel, the bound the
reference holds its own two paths to (tests/test_waveform.py:163): the
float32 dense passes differ in the integer-cycle phase split (the port
splits, the Pallas kernel does not) and in the float32 vs float64 band-limit
compare. The batched form against a loop of the one-walker form: equal, the
same operations on the same numbers.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import summation_fd as j_sfd
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd as t_sfd
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf

F0, DF, NF = 1.7e-3, 2e-8, 20000
R, RUNS = 8, 2048
SOURCE = (1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0)
KW = dict(t_years=0.05, k_max=16, eps=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(pro, table, sigma, prepare):
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    return prepare(pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im, table,
                   pro.sel, (sigma * ymr, sigma * ymi), (ypr, -ypi))


@pytest.fixture(scope="module")
def ref_inputs():
    """The reference test's FDKernelInputs (JAX) and the same carried into
    the port on the CPU."""
    table = default_mode_table(30)
    inp = jax.jit(lambda: _inputs(j_wf.waveform_prologue(*SOURCE, table=table, **KW), table,
                                  j_wf._sigma(table), j_sfd.prepare_fd_inputs))()
    inp_np = jax.tree_util.tree_map(np.asarray, inp)
    return inp, convert.fd_inputs_from_numpy(inp_np, device="cpu")


def _max_over_scale(ref, got):
    worst = 0.0
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64).reshape(-1)
        b = b.double().numpy().reshape(-1)
        assert np.all(np.isfinite(b))
        scale = np.max(np.abs(a))
        assert scale > 0
        worst = max(worst, float(np.max(np.abs(a - b)) / scale))
    return worst


def test_wrapper_matches_reference_pallas_interpret(ref_inputs):
    inp_j, inp_t = ref_inputs
    ref = j_sfd.fd_mode_sum_uniform_pallas(inp_j, F0, DF, NF, bins_per_run=R, band_runs=RUNS,
                                           interpret=True)
    got = t_sfd.fd_mode_sum_uniform_pallas(inp_t, F0, DF, NF, bins_per_run=R, band_runs=RUNS,
                                           interpret=True)
    assert all(o.shape == (1, NF) and o.dtype == torch.float64 for o in got)
    err = _max_over_scale(ref, got)
    print(f"port wrapper vs reference Pallas (interpret) max/scale {err:.3e}")
    assert err < 1e-4


def test_wrapper_matches_reference_xla_banded(ref_inputs):
    inp_j, inp_t = ref_inputs
    ref = jax.jit(lambda i: j_sfd.fd_mode_sum_uniform(i, F0, DF, NF, bins_per_run=R,
                                                      band_runs=RUNS))(inp_j)
    got = t_sfd.fd_mode_sum_uniform_pallas(inp_t, F0, DF, NF, bins_per_run=R, band_runs=RUNS)
    err = _max_over_scale(ref, got)
    print(f"port wrapper vs reference XLA banded kernel max/scale {err:.3e}")
    assert err < 1e-4


def test_batched_equals_loop_of_single():
    table = default_mode_table(30)
    t_table = convert.mode_table_from_numpy(*table)
    p0 = torch.tensor([9.9, 10.0, 10.1], dtype=torch.float64)
    pro = t_wf.waveform_prologue(1e6, 50.0, p0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0, table=t_table,
                                 device="cpu", **KW)
    inp = _inputs(pro, t_table, t_wf._sigma(t_table, "cpu")[None], t_sfd.prepare_fd_inputs)
    # shared offsets from lane 0's first knot frequencies
    f_first = inp.m_sel[0] * inp.f_phi_knots[0, 0] + inp.n_sel[0] * inp.f_r_knots[0, 0]
    offsets = torch.floor((f_first - F0) / (R * DF)).to(torch.int32)
    kw = dict(bins_per_run=R, band_runs=RUNS, band_offsets=offsets)
    batched = t_sfd.fd_mode_sum_uniform_pallas_batched(inp, F0, DF, NF, **kw)
    assert all(o.shape == (3, NF) for o in batched)
    for lane in range(3):
        one = t_sfd.fd_mode_sum_uniform_pallas(
            t_sfd.FDKernelInputs(*(x[lane:lane + 1] for x in inp)), F0, DF, NF, **kw)
        for a, b in zip(batched, one):
            assert bool(a[lane].abs().max() > 0)
            assert torch.equal(a[lane], b[0])


def test_batched_requires_band_offsets(ref_inputs):
    inp_j, inp_t = ref_inputs
    with pytest.raises(ValueError, match="band_offsets"):
        j_sfd.fd_mode_sum_uniform_pallas_batched(
            jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], inp_j), F0, DF, NF)
    with pytest.raises(ValueError, match="band_offsets"):
        t_sfd.fd_mode_sum_uniform_pallas_batched(inp_t, F0, DF, NF)


@pytest.mark.parametrize("band_runs,window", [(RUNS, 2048), (300, 384), (None, 2560)])
def test_window_starts_rounded_down_and_window_padded(ref_inputs, monkeypatch, band_runs, window):
    inp_j, inp_t = ref_inputs
    seen = []
    dense = t_sfd.fd_dense_accumulate

    def keep(groups, *, r, nf):
        seen.append(groups)
        return dense(groups, r=r, nf=nf)

    monkeypatch.setattr(t_sfd, "fd_dense_accumulate", keep)
    t_sfd.fd_mode_sum_uniform_pallas(inp_t, F0, DF, NF, bins_per_run=R, band_runs=band_runs)
    (group,) = seen[0]
    g0 = group.g0[0].numpy()
    # the reference's rule (summation_fd.py:1371-1380) on its own inputs
    f_first = (np.asarray(inp_j.m_sel) * np.asarray(inp_j.f_phi_knots)[0]
               + np.asarray(inp_j.n_sel) * np.asarray(inp_j.f_r_knots)[0])
    g_total = -(-NF // R)
    raw = np.floor((f_first - F0) / (R * DF)).astype(np.int32)
    np.testing.assert_array_equal(g0, np.clip((raw // 128) * 128, 0, g_total))
    # on a 128-run boundary at or below the first knot, or clipped to the grid's end
    assert np.all((g0 % 128 == 0) | (g0 == g_total)) and np.all(g0 <= np.maximum(raw, 0))
    assert group.pc.shape[2] == window and window % 128 == 0
