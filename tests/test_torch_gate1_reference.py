"""Gate 1's kernel cross-check computed by the JAX package itself, on the CPU.

`chip_smoke.py` reads the port's banded full-window spectrum against the
general sorted-grid kernel on the card at 6.1086e-07 off the band edges and
2.4523e-05 on them, far below the 5.6e-4 to 6.6e-4 of the reference's
TPU-era record (bench.py:294-309). This test runs the reference's own
computation at gate 1's configuration: lane 0 of the benchmark's rwz batch
(the `numpy.random.default_rng(7)` jitter of bench.py:173), 1 yr at
dt = 10 s, the l <= 6 table sliced to the 16 frozen slots, the banded
kernel with whole-grid windows and 2 turnover slots against `fd_mode_sum`
on ``arange(0, nf, 617)``, split into band-edge bins and the rest as
`chip_smoke.py::split_rel_l2` and bench.py do. It holds gate 1's bounds
(1e-3 off the edges, 0.05 on them) and prints its numbers beside the card's.
"""

import numpy as np
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import fit_cubic_spline, spline_eval

RWZ = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)
CARD = (6.1086e-07, 2.4523e-05)  # the port on an H100 (chip_smoke.py [gate1])


def _edge_mask(pro, table, f_at, dfu, edge_runs=2.0):
    """bench.py's `_band_edge_mask`: within 2 runs of 64 bins of a live
    band's start, termination or maximum."""
    fphi = np.asarray(spline_eval(fit_cubic_spline(pro.t_knots, pro.phi_phi, bc="not-a-knot"),
                                  pro.t_knots, deriv=1)) / (2 * np.pi)
    fr = np.asarray(spline_eval(fit_cubic_spline(pro.t_knots, pro.phi_r, bc="not-a-knot"),
                                pro.t_knots, deriv=1)) / (2 * np.pi)
    sel, live = np.asarray(pro.sel.idx), np.asarray(pro.sel.mask).astype(bool)
    nl = int(pro.n_live)
    fk = (table.ms[sel].astype(float)[:, None] * fphi[None, :nl]
          + table.ns[sel].astype(float)[:, None] * fr[None, :nl])
    edges = np.concatenate([fk[live][:, 0], fk[live][:, -1], fk[live].max(axis=1)])
    return np.min(np.abs(f_at[:, None] - edges[None, :]), axis=1) < edge_runs * 64 * dfu


def test_banded_vs_general_at_gate1_configuration():
    table = j_amp.default_mode_table(30)
    freq = j_wf.default_frequencies(1.0, 10.0)
    f_np = freq[freq > 0]
    nf = len(f_np)
    f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
    kw = dict(t_years=1.0, k_max=16, eps=1e-2, max_steps=192, **RWZ)
    forced = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(
        1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0, table=table, **kw).sel.idx)())
    table_k = table.take(forced)
    rng = np.random.default_rng(7)  # bench.py's walker jitter; lane 0 of each draw
    p0, e0, th, ph = (c + w * (rng.random(128)[0] - 0.5)
                      for c, w in ((12.0, 0.12), (0.35, 0.03), (0.7, 0.2), (0.5, 0.2)))
    pro = jax.jit(lambda: j_wf.waveform_prologue(
        1e6, 10.0, p0, e0, th, ph, 1.0, 0.0, 0.0, table=table_k,
        forced_idx=np.arange(len(forced)), **kw))()
    sub = np.arange(0, nf, 617)
    banded = jax.jit(lambda p: j_wf.fd_waveform_core(
        p, table_k, jnp.zeros(nf), channels=True, uniform=(f0u, dfu), bins_per_run=64,
        turnover_slots=2))(pro)
    general = jax.jit(lambda p: j_wf.fd_waveform_core(
        p, table_k, jnp.asarray(f_np[sub]), channels=True, turnover_slots=2))(pro)
    is_edge = _edge_mask(pro, table_k, f_np[sub], dfu)
    off = on = 0.0
    for b, g in zip(banded, general):
        b_sub = np.asarray(b, np.float64)[sub]
        err = (b_sub - np.asarray(g, np.float64)) / np.sqrt(np.mean(b_sub**2))
        off = max(off, float(np.sqrt(np.mean(err[~is_edge] ** 2))))
        on = max(on, float(np.sqrt(np.mean(err[is_edge] ** 2))))
    print(f"[reference gate 1, CPU] lane 0 (p0 {p0:.6f}, e0 {e0:.6f}), {len(sub)} bins: banded "
          f"full-window vs general rel L2 {off:.4e} off the band edges, {on:.4e} on "
          f"{int(is_edge.sum())} edge bins ({int(pro.n_live)} knots); the port on the card: "
          f"{CARD[0]:.4e} / {CARD[1]:.4e}")
    assert np.isfinite(off) and off < 1e-3 and on < 0.05
