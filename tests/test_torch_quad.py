"""The PyTorch port's quadrature trajectory (``method="quad"``), against the
JAX package.

Seeded inputs through `models.trajectory_quad` of both packages, under the
Peters-Mathews flux: the reference's three cases (horizon-capped, fast
plunge, light and eccentric), the quad trajectory against the DP5 one at the
reference's own tolerances, the phase offsets, a batch against its lanes run
alone, both sides of the horizon branch in one batch, the waveform through
the quad trajectory and the facade's ``inspiral_kwargs={"method": "quad"}``.
The rwz-flux case lives in tests/test_torch_rwz.py (it needs that file's
carried flux grid).

Tolerances. Port against JAX, quad to quad: every field 1e-9 relative
(measured ~1e-15) and each phase 1e-6 rad (measured ~2e-11 rad over ~1e4
rad). Quad against DP5 within the port: the reference's own 1e-5 (end time),
5e-5 (p, e) and 2e-3 rad. Waveforms: relative L2 <= 1e-5 per channel
against the JAX package (float32 amplitude projection and dense pass).
"""

import ast
import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.interpolate import CubicSpline

from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from emri_frequencydomainwaveforms_tpu_torch.models import trajectory_quad as t_quad
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf

# tests/test_trajectory.py::TestQuadTrajectory.CASES: (M, mu, p0, e0, T)
CASES = [
    (1e6, 50.0, 12.0, 0.4, 0.1),   # horizon-capped
    (1e6, 50.0, 7.8, 0.3, 1.0),    # fast plunge
    (1e5, 10.0, 10.0, 0.5, 0.5),   # light + eccentric
]
FIELDS = ("t", "p", "e", "x", "Phi_phi", "Phi_theta", "Phi_r")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_quad_equal(ref, got, lane=0):
    """Port lane ``lane`` against one JAX quad trajectory: fields 1e-9
    relative to their largest value, phases 1e-6 rad, all knots live."""
    assert int(got.n[lane]) == int(ref.n) == got.t.shape[1]
    for name in FIELDS:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name)[lane].numpy()
        assert np.all(np.isfinite(b)), name
        err = np.max(np.abs(a - b))
        if name.startswith("Phi"):
            assert err <= 1e-6, (name, err)
        else:
            assert err <= 1e-9 * np.max(np.abs(a)), (name, err)


@pytest.mark.parametrize("case", CASES, ids=["capped", "plunge", "light"])
def test_quad_matches_reference(case):
    M, mu, p0, e0, T = case
    ref = j_insp.schwarz_ecc_flux_inspiral(M, mu, p0, e0, t_years=T, max_steps=192, method="quad")
    got = t_insp.schwarz_ecc_flux_inspiral(M, mu, p0, e0, t_years=T, max_steps=192, method="quad",
                                           device="cpu")
    assert got.t.shape == (1, 192) and got.n.dtype == torch.int32
    _assert_quad_equal(ref, got)


@pytest.mark.parametrize("case", CASES, ids=["capped", "plunge", "light"])
def test_quad_matches_dp5(case):
    # the reference's own check (tests/test_trajectory.py:256-286), in the port
    M, mu, p0, e0, T = case
    ref = t_insp.schwarz_ecc_flux_inspiral(M, mu, p0, e0, t_years=T, max_steps=384, rtol=1e-11,
                                           device="cpu")
    q = t_insp.schwarz_ecc_flux_inspiral(M, mu, p0, e0, t_years=T, max_steps=192, method="quad",
                                         device="cpu")
    n = int(ref.n[0])
    tr = ref.t[0, :n].numpy()
    tq = q.t[0].numpy()
    assert abs(tq[-1] / tr[-1] - 1.0) < 1e-5
    m = tr <= tq[-1]
    for name, tol in (("p", 5e-5), ("e", 5e-5), ("Phi_phi", 2e-3), ("Phi_r", 2e-3)):
        qi = CubicSpline(tq, getattr(q, name)[0].numpy())(tr[m])
        err = np.max(np.abs(qi - getattr(ref, name)[0, :n].numpy()[m]))
        assert err < tol, (name, err, tol)


def test_phase_offsets_and_monotone_time():
    kw = dict(t_years=0.1, max_steps=96, method="quad", device="cpu")
    q0 = t_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, 12.0, 0.4, **kw)
    q1 = t_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, 12.0, 0.4, Phi_phi0=1.0, Phi_r0=2.0, **kw)
    np.testing.assert_allclose((q1.Phi_phi - q0.Phi_phi).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((q1.Phi_r - q0.Phi_r).numpy(), 2.0, rtol=1e-12)
    assert bool((torch.diff(q0.t, dim=-1) > 0).all())
    assert int(q0.n[0]) == 96  # all knots live
    assert bool((q0.x == 1.0).all()) and bool((q0.Phi_theta == 0.0).all())


def test_batch_equals_lanes_alone():
    # the reference vmaps a single-lane function; the port's batch of 3
    # gives each lane exactly what it gives that lane alone
    p0s, e0s = [11.8, 12.0, 12.2], [0.38, 0.40, 0.42]
    kw = dict(t_years=0.1, max_steps=96, method="quad", device="cpu")
    batch = t_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, torch.tensor(p0s, dtype=torch.float64),
                                             torch.tensor(e0s, dtype=torch.float64), **kw)
    assert batch.Phi_phi.shape == (3, 96)
    for i, (p0, e0) in enumerate(zip(p0s, e0s)):
        alone = t_insp.schwarz_ecc_flux_inspiral(1e6, 50.0, p0, e0, **kw)
        for name in FIELDS:
            np.testing.assert_allclose(getattr(batch, name)[i].numpy(),
                                       getattr(alone, name)[0].numpy(), rtol=1e-14, atol=0)


def test_both_branches_in_one_batch():
    # a horizon-capped lane (bisection for p(t_max)) and a plunging lane
    # (the plunge-bounded grid) in one batch, each against the reference
    lanes = [(1e6, 50.0, 12.0, 0.4), (1e6, 50.0, 7.8, 0.3)]
    t_years = 0.5
    m, mu, p0, e0 = (torch.tensor(c, dtype=torch.float64) for c in zip(*lanes))
    got = t_quad.schwarz_ecc_flux_inspiral_quad(m, mu, p0, e0, t_years=t_years, max_steps=128)
    year = 31558149.763545603
    ends = got.t[:, -1].numpy() / year
    assert abs(ends[0] - t_years) < 1e-9 and ends[1] < 0.9 * t_years
    p_sep = 6.0 + 2.0 * got.e[1, -1].item()
    assert abs(got.p[1, -1].item() - (p_sep + 0.12)) < 0.05
    for i, (M, mu_i, p0_i, e0_i) in enumerate(lanes):
        ref = j_insp.schwarz_ecc_flux_inspiral(M, mu_i, p0_i, e0_i, t_years=t_years, max_steps=128,
                                               method="quad")
        _assert_quad_equal(ref, got, lane=i)


@pytest.fixture(scope="module")
def quad_waveforms():
    """tests/test_trajectory.py:327-370's configuration (0.1 yr, l <= 2,
    k_max 8, the mode set pinned to dp5's eps selection): the JAX pair and
    the port's, dp5 at 256 knots and quad at 128."""
    table = default_mode_table(8, l_max=2)
    t_table = convert.mode_table_from_numpy(*table)
    freq = j_wf.default_frequencies(0.1, 10.0)
    f_np = freq[freq > 0]
    uni = (float(f_np[0]), float(f_np[1] - f_np[0]))
    params = (1e6, 50.0, 12.0, 0.4, 0.7, 0.5, 1.0, 0.0, 0.0)
    kw = dict(t_years=0.1, k_max=8, eps=1e-2)
    forced = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(
        *params, table=table, max_steps=256, **kw).sel.idx)())
    out = {}
    for method, msteps in (("dp5", 256), ("quad", 128)):
        pro_j = jax.jit(lambda: j_wf.waveform_prologue(
            *params, table=table, forced_idx=forced, max_steps=msteps, traj_method=method, **kw))()
        out["jax", method] = [np.asarray(o) for o in jax.jit(lambda p: j_wf.fd_waveform_core(
            p, table, jnp.asarray(f_np), channels=True, uniform=uni))(pro_j)]
        pro_t = t_wf.waveform_prologue(*params, table=t_table, forced_idx=forced, max_steps=msteps,
                                       traj_method=method, device="cpu", **kw)
        out["torch", method] = [o[0].numpy() for o in t_wf.fd_waveform_core(
            pro_t, t_table, torch.as_tensor(f_np), channels=True, uniform=uni)]
    return out


def _rel_l2(ref, got):
    return np.linalg.norm(ref - got) / np.linalg.norm(ref)


def test_waveform_through_quad_trajectory(quad_waveforms):
    # the port's prologue + FD core with traj_method="quad" against the JAX
    # pair, relative L2 <= 1e-5 per channel
    for a, b in zip(quad_waveforms["jax", "quad"], quad_waveforms["torch", "quad"]):
        assert np.all(np.isfinite(b)) and _rel_l2(a, b) <= 1e-5


def test_waveform_quad_vs_dp5(quad_waveforms):
    # the reference's bound between the two trajectories' waveforms
    # (tests/test_trajectory.py:367-370), in the port
    for a, b in zip(quad_waveforms["torch", "dp5"], quad_waveforms["torch", "quad"]):
        scale = np.sqrt(np.mean(a**2)) + 1e-300
        assert np.sqrt(np.mean((a - b) ** 2)) / scale < 1e-3


def test_facade_with_quad_method(quad_waveforms):
    # GenerateEMRIWaveform passes inspiral_kwargs["method"] through: the
    # source-frame facade's FD channels equal the functional path's
    gen = t_wf.FastSchwarzschildEccentricFlux(
        inspiral_kwargs={"method": "quad", "max_steps": 128},
        amplitude_kwargs=dict(tail=False, factorized=False, rwz=False),
        sum_kwargs=dict(output_type="fd", flux="pm", turnover_slots=0),
        n_max=8, l_max=2, device="cpu")
    assert gen.traj_method == "quad"
    table = default_mode_table(8, l_max=2)
    modes = [(int(table.ls[i]), int(table.ms[i]), int(table.ns[i])) for i in range(table.ls.size)]
    forced = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(
        1e6, 50.0, 12.0, 0.4, 0.7, 0.5, 1.0, 0.0, 0.0, t_years=0.1, table=table, k_max=8,
        eps=1e-2, max_steps=256).sel.idx)())
    hp, hc = gen(1e6, 50.0, 12.0, 0.4, 0.7, 0.5, T=0.1, dt=10.0,
                 mode_selection=[modes[i] for i in forced], mask_positive=True,
                 return_channels=True)
    ref = quad_waveforms["torch", "quad"]
    pos = gen.frequency[gen.frequency >= 0]
    keep = pos > 0
    np.testing.assert_allclose(hp[keep].real, ref[0], rtol=0, atol=1e-6 * np.abs(ref[0]).max())
    np.testing.assert_allclose(hc[keep].imag, ref[3], rtol=0, atol=1e-6 * np.abs(ref[3]).max())
    facade = t_wf.GenerateEMRIWaveform(inspiral_kwargs={"method": "quad"}, device="cpu")
    assert facade.waveform_generator.traj_method == "quad"


def test_quad_has_no_host_sync():
    # the quad trajectory is issued without one host synchronization: no
    # call in its module reads a tensor back (.item(), .cpu(), .tolist(),
    # .numpy(), bool(), float(), int())
    tree = ast.parse(inspect.getsource(t_quad))
    calls = [node.func for node in ast.walk(tree) if isinstance(node, ast.Call)]
    bad = [ast.unparse(f) for f in calls
           if (isinstance(f, ast.Attribute) and f.attr in ("item", "cpu", "tolist", "numpy"))
           or (isinstance(f, ast.Name) and f.id in ("bool", "float", "int"))]
    assert not bad, bad
    assert len(calls) > 50
