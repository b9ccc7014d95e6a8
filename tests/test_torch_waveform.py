"""The PyTorch port's FD waveform slice end to end, against the JAX package.

Two configurations of the reference's own tests, each checked two ways —
reference prologue -> `convert` -> port core, and port prologue -> port core:

1. tests/test_waveform.py's Pallas configuration: a 0.05-yr source, the
   l <= 6 table with eps selection, a 20000-bin uniform grid (the core's
   run-size rule picks r = 2 there), 2 turnover and 1 negative slot.
2. tests/test_waveform.py's frozen-selection configuration: the l <= 2
   table, 0.1 yr on the default 10-s grid, the slot layout frozen from a
   representative source, the table sliced to it, shared window offsets and
   2 turnover slots, float32 output — the reference benchmark's shape at
   small size, driven through `FrozenFDWaveform`.

Tolerance per channel: relative L2 <= 1e-5 and max/scale <= 1e-4 (float32
dense pass, float32 amplitude projection).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(ref, got, lane=0):
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = b[lane].double().numpy()
        assert np.all(np.isfinite(b))
        scale = np.max(np.abs(a))
        assert scale > 0
        assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-5
        assert np.max(np.abs(a - b)) / scale <= 1e-4


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_eps_selected_source_uniform_grid():
    table = default_mode_table(30)
    args = (1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0)
    kw = dict(t_years=0.05, table=table, k_max=16, eps=1e-2)
    f0, df, nf = 1.7e-3, 2e-8, 20000
    core = dict(channels=True, uniform=(f0, df), band_runs=2048, bins_per_run=8,
                turnover_slots=2, negative_slots=1, extra_band_runs=64)
    pro_j = jax.jit(lambda: j_wf.waveform_prologue(*args, **kw))()
    ref = jax.jit(lambda p: j_wf.fd_waveform_core(p, table, jnp.zeros(nf), **core))(pro_j)

    t_table = convert.mode_table_from_numpy(*table)
    pro_t = t_wf.waveform_prologue(*args, **kw, device="cpu")
    assert int(pro_t.n_live[0]) == int(pro_j.n_live)
    np.testing.assert_array_equal(pro_t.sel.idx[0].numpy(), np.asarray(pro_j.sel.idx))
    np.testing.assert_array_equal(pro_t.sel.mask[0].numpy(), np.asarray(pro_j.sel.mask))
    for pro in (convert.prologue_from_numpy(_to_numpy(pro_j), device="cpu"), pro_t):
        got = t_wf.fd_waveform_core(pro, t_table, nf, **core)
        assert got[0].shape == (1, nf) and got[0].dtype == torch.float64
        _assert_close(ref, got)


def test_frozen_batch_matches_reference():
    table = default_mode_table(16, l_max=2)
    freq = j_wf.default_frequencies(0.1, 10.0)
    np.testing.assert_array_equal(t_wf.default_frequencies(0.1, 10.0), freq)
    np.testing.assert_array_equal(t_wf.default_time_grid(0.1, 10.0), j_wf.default_time_grid(0.1, 10.0))
    f_np = freq[freq > 0]
    nf = len(f_np)
    f0, df = float(f_np[0]), float(f_np[1] - f_np[0])
    src = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)
    kw = dict(t_years=0.1, k_max=16, eps=1e-2, max_steps=128)

    # representative source with eps selection; both packages pick the same slots
    pro_sel = jax.jit(lambda: j_wf.waveform_prologue(*src, table=table, **kw))()
    pro_sel_t = t_wf.waveform_prologue(
        *src, table=convert.mode_table_from_numpy(*table), **kw, device="cpu")
    np.testing.assert_array_equal(pro_sel_t.sel.idx[0].numpy(), np.asarray(pro_sel.sel.idx))
    fz = j_wf.freeze_mode_selection(pro_sel, table, f0, df)
    table_k = table.take(fz.forced_idx)
    idx_k = np.arange(len(fz.forced_idx))

    # shared window offsets from the sliced-table representative prologue
    pro0 = jax.jit(lambda: j_wf.waveform_prologue(
        *src, table=table_k, forced_idx=idx_k, **kw))()
    offsets = j_wf.band_offsets_for(pro0, table_k, f0, df, fz.bins_per_run, fz.band_runs)
    pro0_t = t_wf.waveform_prologue(
        *src, table=convert.mode_table_from_numpy(*table_k), forced_idx=idx_k, **kw, device="cpu")
    np.testing.assert_array_equal(
        t_wf.band_offsets_for(pro0_t, convert.mode_table_from_numpy(*table_k), f0, df, fz.bins_per_run, fz.band_runs),
        offsets,
    )

    core = dict(channels=True, uniform=(f0, df), band_runs=fz.band_runs,
                band_offsets=offsets, bins_per_run=fz.bins_per_run, turnover_slots=2,
                extra_band_runs=64, band_offsets_extra=np.zeros(2, np.int32), out_f32=True)
    lanes = [(12.03, 0.352, 0.72, 0.52), (11.97, 0.348, 0.69, 0.47)]
    gen = t_wf.FrozenFDWaveform(
        convert.mode_table_from_numpy(*table_k), offsets, f0=f0, df=df, nf=nf, t_years=0.1, max_steps=128,
        bins_per_run=fz.bins_per_run, band_runs=fz.band_runs, turnover_slots=2,
        extra_band_runs=64, device="cpu",
    )
    batch = [torch.tensor(v, dtype=torch.float64) for v in zip(*lanes)]
    got_batch = gen(*batch)
    assert all(o.shape == (2, nf) and o.dtype == torch.float32 for o in got_batch)
    for lane, (p0, e0, th, ph) in enumerate(lanes):
        pro = jax.jit(lambda: j_wf.waveform_prologue(
            1e6, 10.0, p0, e0, th, ph, 1.0, 0.0, 0.0,
            table=table_k, forced_idx=idx_k, **kw))()
        ref = jax.jit(lambda p: j_wf.fd_waveform_core(
            p, table_k, jnp.zeros(nf), **{**core, "band_offsets": jnp.asarray(offsets)}))(pro)
        assert all(np.asarray(r).dtype == np.float32 for r in ref)
        # port prologue -> port core, batched through the module
        _assert_close(ref, got_batch, lane)
        if lane == 0:
            # reference prologue -> convert -> port core
            got = t_wf.fd_waveform_core(
                convert.prologue_from_numpy(_to_numpy(pro), device="cpu"),
                convert.mode_table_from_numpy(*table_k), nf, **core,
            )
            _assert_close(ref, got)
            # a short signal: its content fills a thin slice of the grid
            assert np.count_nonzero(np.asarray(ref[0])) > 100
