"""The JAX package's quad-vs-dp5 distance at the card batch's extreme lanes.

`chip_smoke.py`'s [quad] phase reads the port's quad trajectory against its
dp5 one over the 128 lanes of the benchmark's rwz batch and names the lane
with the largest FD relative L2 and the lane with the largest |dPhi_phi|.
This test computes the same two numbers with the JAX package on the CPU at
those lanes: their (p0, e0, theta, phi) from bench.py:173's
`numpy.random.default_rng(7)` jitter, the slots frozen from the
representative source's eps selection, its shared 256-run windows, 2
turnover slots, 1 yr of rwz physics; as
`tests/test_torch_rwz.py::test_quad_vs_dp5_yardstick_reference` does for
the representative source itself. It prints each lane's values beside the
card's and holds the reference test's bounds (2e-3 rad, 1e-3).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.interpolate import CubicSpline

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf

RWZ = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)
SOURCE = (1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0)
# lane -> the card's (FD rel L2, max |dPhi_phi| rad), chip_smoke.py [quad]
# on an NVIDIA H100 80GB HBM3 at 700 W: lane 68 has the batch's largest FD
# rel L2, lane 124 its largest |dPhi_phi|
CARD = {68: (3.2938e-04, 1.4511e-04), 124: (2.8350e-04, 1.8752e-04)}


@pytest.fixture(scope="module")
def setup():
    table = j_amp.default_mode_table(30)
    freq = j_wf.default_frequencies(1.0, 10.0)
    f_np = freq[freq > 0]
    f0, df = float(f_np[0]), float(f_np[1] - f_np[0])
    kw = dict(t_years=1.0, k_max=16, eps=1e-2, max_steps=192, **RWZ)
    idx = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(*SOURCE, table=table, **kw).sel.idx)())
    table_k = table.take(idx)
    kw_k = dict(kw, table=table_k, forced_idx=np.arange(len(idx)))
    offsets = j_wf.band_offsets_for(jax.jit(lambda: j_wf.waveform_prologue(*SOURCE, **kw_k))(),
                                    table_k, f0, df, 64, 256)
    core = jax.jit(lambda p: j_wf.fd_waveform_core(
        p, table_k, jnp.zeros(len(f_np)), channels=True, uniform=(f0, df), band_runs=256,
        band_offsets=offsets, bins_per_run=64, turnover_slots=2, extra_band_runs=64,
        out_f32=True))
    rng = np.random.default_rng(7)  # bench.py's walker jitter
    lanes = [c + w * (rng.random(128) - 0.5)
             for c, w in ((12.0, 0.12), (0.35, 0.03), (0.7, 0.2), (0.5, 0.2))]
    return kw_k, core, lanes


@pytest.mark.parametrize("lane", sorted(CARD))
def test_quad_vs_dp5_at_the_card_batch_extremes(setup, lane):
    kw_k, core, lanes = setup
    p0, e0, th, ph = (float(x[lane]) for x in lanes)
    pros, outs = {}, {}
    for method in ("dp5", "quad"):
        pros[method] = jax.jit(lambda: j_wf.waveform_prologue(
            1e6, 10.0, p0, e0, th, ph, 1.0, 0.0, 0.0, traj_method=method, **kw_k))()
        outs[method] = [np.asarray(o, np.float64) for o in core(pros[method])]
    d, q = pros["dp5"], pros["quad"]
    n = int(d.n_live)
    t_d, t_q = np.asarray(d.t_knots)[:n], np.asarray(q.t_knots)
    on = t_d <= t_q[-1]
    dphi = np.max(np.abs(CubicSpline(t_q, np.asarray(q.phi_phi))(t_d[on])
                         - np.asarray(d.phi_phi)[:n][on]))
    rel = max(np.linalg.norm(a - b) / np.linalg.norm(a) for a, b in zip(outs["dp5"], outs["quad"]))
    print(f"[reference quad vs dp5, lane {lane} (p0 {p0:.6f}, e0 {e0:.6f})] FD rel L2 {rel:.4e}, "
          f"max |dPhi_phi| {dphi:.4e} rad at dp5's {n} knots; the card: {CARD[lane][0]:.4e}, "
          f"{CARD[lane][1]:.4e} rad")
    assert np.isfinite(rel) and dphi < 2e-3 and rel < 1e-3
