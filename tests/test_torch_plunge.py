"""Gate 1c's plunging-source cross-check through both packages.

``bench.py``'s gate 1c holds the banded kernel with its turnover slots
against the general sorted-grid kernel on a source that plunges inside the
observation, and reports the relative L2 apart on the bins within two runs
of a band's start, termination or maximum ("on the terminations") and on
the rest ("off"). Here the same split runs through both packages on one
carried reference prologue, at CPU size: the gate's plunging source
(M = 1e6, mu = 50, p0 = 7.6, e0 = 0.3; it plunges at ~0.02 yr) over 0.05 yr
on the default 10-s grid (78,894 positive bins, runs of 9 bins), the full
l <= 6 table with eps selection, rwz amplitudes on a Peters-Mathews
trajectory (no flux grid is built).

Tolerances: each kernel's output against the reference's, relative L2
<= 1e-5 per channel; the split values of the two packages within 10 % of
each other; both under the gate's limits (1e-3 off, 0.3 on).
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

PLUNGING = (1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0)
T_YEARS, DT = 0.05, 10.0
EDGE_RUNS = 2.0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _edge_mask(pro, table, f_at, run_df):
    """Bins within EDGE_RUNS runs of a live band's start, termination or
    maximum (the reference prologue's knot frequencies)."""
    from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import fit_cubic_spline, spline_eval

    n = int(pro.n_live)
    fr = [np.asarray(spline_eval(fit_cubic_spline(pro.t_knots, ph, bc="not-a-knot"),
                                 pro.t_knots, deriv=1))[:n] / (2 * np.pi)
          for ph in (pro.phi_phi, pro.phi_r)]
    sel = np.asarray(pro.sel.idx)
    live = np.asarray(pro.sel.mask).astype(bool)
    fk = (table.ms[sel].astype(float)[:, None] * fr[0][None]
          + table.ns[sel].astype(float)[:, None] * fr[1][None])[live]
    edges = np.concatenate([fk[:, 0], fk[:, -1], fk.max(axis=1)])
    return np.min(np.abs(f_at[:, None] - edges[None, :]), axis=1) < EDGE_RUNS * run_df


def _split(banded, general, sub, is_edge):
    """Worst channel's relative L2 of banded[sub] - general off / on the edges."""
    off = on = 0.0
    for b_full, g in zip(banded, general):
        b = np.asarray(b_full, np.float64).reshape(-1)[sub]
        err = (b - np.asarray(g, np.float64).reshape(-1)) / np.sqrt(np.mean(b**2))
        off = max(off, float(np.sqrt(np.mean(err[~is_edge] ** 2))))
        on = max(on, float(np.sqrt(np.mean(err[is_edge] ** 2))))
    return off, on


def test_gate1c_split_matches_reference():
    table = default_mode_table(30)
    phys = dict(flux="pm", tail=True, factorized=True, rwz=True)
    pro = jax.jit(lambda: j_wf.waveform_prologue(
        *PLUNGING, t_years=T_YEARS, table=table, k_max=16, eps=1e-2, max_steps=192, **phys))()
    t_end = float(pro.t_end) / 31558149.763545603
    assert t_end < 0.6 * T_YEARS and int(pro.n_live) < 192  # it plunges inside the window
    freq = j_wf.default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    nf = len(f_np)
    f0, df = float(f_np[0]), float(f_np[1] - f_np[0])
    sub = np.arange(0, nf, 53)
    r = max(1, min(64, nf // 8192))  # the core's run size for this grid
    kw = dict(channels=True, turnover_slots=2)

    banded_j = jax.jit(lambda p: j_wf.fd_waveform_core(
        p, table, jnp.asarray(f_np), uniform=(f0, df), bins_per_run=64, extra_band_runs=None,
        **kw))(pro)
    general_j = jax.jit(lambda p: j_wf.fd_waveform_core(p, table, jnp.asarray(f_np[sub]), **kw))(pro)
    pro_t = convert.prologue_from_numpy(jax.tree_util.tree_map(np.asarray, pro), device="cpu")
    t_table = convert.mode_table_from_numpy(*table)
    banded_t = t_wf.fd_waveform_core(pro_t, t_table, nf, uniform=(f0, df), bins_per_run=64,
                                     extra_band_runs=None, **kw)
    general_t = t_wf.fd_waveform_core(pro_t, t_table, torch.from_numpy(f_np[sub]), **kw)
    for ref, got in ((banded_j, banded_t), (general_j, general_t)):
        for a, b in zip(ref, got):
            a, b = np.asarray(a), b[0].numpy()
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(a)

    is_edge = _edge_mask(pro, table, f_np[sub], r * df)
    assert 0 < is_edge.sum() < len(sub) // 4
    off_j, on_j = _split(banded_j, general_j, sub, is_edge)
    off_t, on_t = _split([b[0].numpy() for b in banded_t], [g[0].numpy() for g in general_t],
                         sub, is_edge)
    assert off_j < 1e-3 and on_j < 0.3
    assert abs(off_t - off_j) <= 0.1 * off_j
    assert abs(on_t - on_j) <= 0.1 * on_j
