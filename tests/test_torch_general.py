"""The PyTorch port's general sorted-grid FD kernel and frozen-selection
helpers, against the JAX package.

`fd_mode_sum` is the independent check of the banded kernel: it places its
nodes in time, not in frequency, and takes any ascending grid. Here it runs
on the reference's own `FDKernelInputs` (carried across by
`convert.fd_inputs_from_numpy`) for flat and rwz amplitudes (the rwz
envelope rotates along each band), with and without the turnover and
negative-frequency slots, on an unevenly spaced grid; then through
`fd_waveform_core(uniform=None)`, and against the port's own banded kernel.
The rwz amplitudes ride a Peters-Mathews trajectory, so no flux grid is
built here.

Tolerance per output: relative L2 <= 1e-5 and max/scale <= 1e-4 (float32
sin/cos, envelope and accumulation in both packages; the phase Horner is
float64 in both).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import summation_fd as j_sfd
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models.modeselect import mode_power as j_mode_power
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd as t_sfd
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.models.modeselect import mode_power as t_mode_power

PHYSICS = {"flat": dict(), "rwz": dict(tail=True, factorized=True, rwz=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close(ref, got, lane=0):
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = b[lane].double().numpy()
        assert np.all(np.isfinite(b))
        assert np.max(np.abs(a)) > 0
        assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-5
        assert np.max(np.abs(a - b)) / np.max(np.abs(a)) <= 1e-4


def _uneven_grid(rng, lo, hi, n):
    """Ascending frequencies with spacings that vary by ~30x."""
    steps = rng.uniform(0.05, 1.0, n) ** 2
    return lo + (hi - lo) * np.cumsum(steps) / np.sum(steps)


# slots of the plunging source: chirping harmonics, an m = 0 harmonic that
# turns over before the plunge, and retrograde harmonics whose frequency is
# negative and falling (the direct-term branch)
_SLOTS = [(2, 2, 0), (2, 2, 1), (2, 2, 2), (2, 2, -1), (3, 3, 0), (3, 3, 1), (2, 1, 1), (2, 1, 2),
          (3, 2, 1), (4, 4, 0), (4, 4, 1), (2, 0, 2), (2, 1, -5), (2, 2, -9), (3, 1, -6), (2, 1, -7)]


@pytest.fixture(scope="module")
def plunging():
    """Reference prologues of a source that plunges inside the horizon, for
    the flat and the rwz amplitudes, with `_SLOTS` forced (equal selection
    powers, so the extra slots are ranked by the tie rule)."""
    table = default_mode_table(30)
    lmn = list(zip(table.ls.tolist(), table.ms.tolist(), table.ns.tolist()))
    forced = np.array([lmn.index(m) for m in _SLOTS])
    out = {}
    for name, phys in PHYSICS.items():
        out[name] = jax.jit(lambda phys=phys: j_wf.waveform_prologue(
            1e6, 100.0, 9.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0, t_years=0.2, table=table,
            k_max=16, eps=1e-2, max_steps=128, forced_idx=forced, **phys))()
    return table, out


def _inputs(table, pro):
    sig = j_wf._sigma(table)
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    return j_sfd.prepare_fd_inputs(
        pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im, table, pro.sel,
        (sig * ymr, sig * ymi), (ypr, -ypi), w1n=(ypr, ypi), w2n=(sig * ymr, -sig * ymi),
    )


@pytest.mark.parametrize("slots", [(0, 0), (2, 1)], ids=["main_only", "turnover_negative"])
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_fd_mode_sum_on_carried_inputs(plunging, physics, slots):
    table, pros = plunging
    inp = _inputs(table, pros[physics])
    assert float(jnp.sum(inp.dec_live)) > 0 and float(jnp.sum(inp.neg_live)) > 0
    rng = np.random.default_rng(61)
    f_all = np.asarray(inp.m_sel)[:, None] * np.asarray(inp.f_phi_knots) \
        + np.asarray(inp.n_sel)[:, None] * np.asarray(inp.f_r_knots)
    f_pos = _uneven_grid(rng, 2e-4, 1.05 * np.abs(f_all).max(), 6000)
    # a bin exactly on a node frequency (the window-start knot of slot 0)
    f_pos[np.searchsorted(f_pos, f_all[0, 0])] = f_all[0, 0]
    kw = dict(nodes_per_segment=8, turnover_slots=slots[0], negative_slots=slots[1])
    ref = jax.jit(lambda i, f: j_sfd.fd_mode_sum(i, f, **kw))(inp, jnp.asarray(f_pos))
    t_inp = convert.fd_inputs_from_numpy(_to_numpy(inp), device="cpu")
    got = t_sfd.fd_mode_sum(t_inp, torch.from_numpy(f_pos), **kw)
    assert got[0].shape == (1, len(f_pos)) and got[0].dtype == torch.float64
    _assert_close(ref, got)
    if slots != (0, 0):
        # the extra slots carry content of their own
        main = jax.jit(lambda i, f: j_sfd.fd_mode_sum(i, f, nodes_per_segment=8))(
            inp, jnp.asarray(f_pos))
        assert np.linalg.norm(np.asarray(ref[0]) - np.asarray(main[0])) > 1e-3 * np.linalg.norm(
            np.asarray(main[0]))


def test_fd_mode_sum_batch_lanes_are_independent(plunging):
    table, pros = plunging
    lanes = [convert.fd_inputs_from_numpy(_to_numpy(_inputs(table, pros[k])), device="cpu")
             for k in ("flat", "rwz")]
    both = t_sfd.FDKernelInputs(*(torch.cat(pair) for pair in zip(*lanes)))
    f_pos = torch.from_numpy(_uneven_grid(np.random.default_rng(62), 5e-4, 9e-3, 3000))
    kw = dict(nodes_per_segment=8, turnover_slots=2, negative_slots=1)
    got = t_sfd.fd_mode_sum(both, f_pos, **kw)
    for i, lane in enumerate(lanes):
        alone = t_sfd.fd_mode_sum(lane, f_pos, **kw)
        for a, b in zip(alone, got):
            assert torch.equal(a[0], b[i])


@pytest.mark.parametrize("physics", list(PHYSICS))
def test_fd_waveform_core_general_branch(plunging, physics):
    table, pros = plunging
    pro = pros[physics]
    t_table = convert.mode_table_from_numpy(*table)
    f_pos = _uneven_grid(np.random.default_rng(63), 4e-4, 1.2e-2, 5000)
    for channels in (True, False):
        kw = dict(channels=channels, turnover_slots=2, negative_slots=1, nodes_per_segment=8)
        ref = jax.jit(lambda p, f: j_wf.fd_waveform_core(p, table, f, **kw))(pro, jnp.asarray(f_pos))
        got = t_wf.fd_waveform_core(
            convert.prologue_from_numpy(_to_numpy(pro), device="cpu"), t_table,
            torch.from_numpy(f_pos), **kw)
        _assert_close(ref, got)


def test_frozen_selection_and_banded_vs_general():
    """`freeze_mode_selection` and `coverage_of` on a carried prologue, then
    the port's frozen banded output against the port's general kernel inside
    the occupied band, as tests/test_waveform.py does for the reference
    (same 3e-2 limit: the subset includes band-edge bins)."""
    table = default_mode_table(16, l_max=2)
    t_table = convert.mode_table_from_numpy(*table)
    freq = j_wf.default_frequencies(0.1, 10.0)
    f_np = freq[freq > 0]
    f0, df = float(f_np[0]), float(f_np[1] - f_np[0])
    kw = dict(t_years=0.1, eps=1e-2, max_steps=128)
    pro = jax.jit(lambda: j_wf.waveform_prologue(
        1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0, table=table, k_max=16, **kw))()
    pro_t = convert.prologue_from_numpy(_to_numpy(pro), device="cpu")
    for opts in (dict(), dict(k_slots=5, band_runs=128), dict(margin_frac=0.3, drift_frac=0.05)):
        fz = j_wf.freeze_mode_selection(pro, table, f0, df, **opts)
        fz_t = t_wf.freeze_mode_selection(pro_t, t_table, f0, df, **opts)
        np.testing.assert_array_equal(fz_t.forced_idx, fz.forced_idx)
        np.testing.assert_array_equal(fz_t.band_offsets, fz.band_offsets)
        assert (fz_t.bins_per_run, fz_t.band_runs) == (fz.bins_per_run, fz.band_runs)
    fz = j_wf.freeze_mode_selection(pro, table, f0, df)
    fz_t = t_wf.freeze_mode_selection(pro_t, t_table, f0, df)

    # a drifted lane with the frozen slots
    lane = (1e6, 10.0, 12.03, 0.352, 0.72, 0.52, 1.0, 0.0, 0.0)
    pro_l = jax.jit(lambda: j_wf.waveform_prologue(
        *lane, table=table, k_max=len(fz.forced_idx), forced_idx=fz.forced_idx, **kw))()
    pro_lt = convert.prologue_from_numpy(_to_numpy(pro_l), device="cpu")
    live = (np.arange(pro_l.t_knots.shape[0]) < int(pro_l.n_live)).astype(np.float64)
    power = j_mode_power(pro_l.a_re, pro_l.a_im, *pro_l.y_plus, *pro_l.y_minus,
                         dt_weights=jnp.asarray(live))
    power_t = t_mode_power(pro_lt.a_re, pro_lt.a_im, *pro_lt.y_plus, *pro_lt.y_minus,
                           dt_weights=torch.from_numpy(live)[None])
    cov, cov_t = float(j_wf.coverage_of(fz, power)), t_wf.coverage_of(fz_t, power_t)
    assert cov_t.shape == (1,) and abs(float(cov_t[0]) - cov) < 1e-12 * cov
    assert cov > 1.0 - 1.25e-2

    out = t_wf.fd_waveform_core(
        pro_lt, t_table, len(f_np), channels=True, uniform=(f0, df), band_runs=fz_t.band_runs,
        band_offsets=fz_t.band_offsets, bins_per_run=fz_t.bins_per_run)
    band = out[0][0].numpy()
    occupied = np.nonzero(np.abs(band) > 0)[0]
    sub = np.arange(occupied[0], occupied[-1], 7)
    gen = t_wf.fd_waveform_core(pro_lt, t_table, torch.from_numpy(f_np[sub]), channels=True)
    b, g = band[sub], gen[0][0].numpy()
    assert np.sqrt(np.mean((b - g) ** 2)) / np.sqrt(np.mean(b**2)) < 3e-2
    # and the general kernel itself against the reference's on that subset
    ref = jax.jit(lambda p, f: j_wf.fd_waveform_core(p, table, f, channels=True))(
        pro_l, jnp.asarray(f_np[sub]))
    _assert_close(ref, gen)
