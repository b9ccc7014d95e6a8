"""Parity of the PyTorch port's trajectory stack with the JAX package.

Schwarzschild geodesics, the Peters-Mathews flux balance (closed-form
Jacobian in the port, ``jax.jacfwd`` in the reference), the batched DP5
integrator and the p0(T) bisection. The adaptive step sequences may differ
by a few steps (see `test_dp5_inspiral_batch`), so trajectories are compared
through a spline of each at fixed times: 1e-9 relative (measured ~1e-12).
"""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import flux as j_flux
from emri_frequencydomainwaveforms_tpu.models import geodesic as j_geo
from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu_torch.models import flux as t_flux
from emri_frequencydomainwaveforms_tpu_torch.models import geodesic as t_geo
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from emri_frequencydomainwaveforms_tpu_torch.models.integrate import integrate_inspiral, pad_knots
from emri_frequencydomainwaveforms_tpu_torch.ops import dp5_inspiral as t_dp5
from emri_frequencydomainwaveforms_tpu_torch.ops import row_ops
from emri_frequencydomainwaveforms_tpu_torch.ops.cubic_spline import (
    fit_cubic_spline,
    spline_eval,
)
from emri_frequencydomainwaveforms_tpu_torch.testing.row_order import WARP, row_sum_order
from emri_frequencydomainwaveforms_tpu_torch.utils import tracing
from emri_frequencydomainwaveforms_tpu_torch.utils.constants import MTSUN_SI, YRSID_SI

_REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b) / np.abs(a))


@pytest.fixture(scope="module")
def orbits():
    rng = np.random.default_rng(21)
    e = rng.uniform(0.05, 0.6, 8)
    p = 6.0 + 2.0 * e + rng.uniform(0.3, 8.0, 8)
    return p, e


def test_geodesic(orbits):
    p, e = orbits
    pt, et = torch.from_numpy(p), torch.from_numpy(e)
    assert _rel(j_geo.separatrix(jnp.asarray(e)), t_geo.separatrix(et)) == 0.0
    for a, b in zip(j_geo.energy_angmom(jnp.asarray(p), jnp.asarray(e)),
                    t_geo.energy_angmom(pt, et)):
        assert _rel(a, b) < 1e-14
    for a, b in zip(j_geo.fundamental_frequencies(jnp.asarray(p), jnp.asarray(e)),
                    t_geo.fundamental_frequencies(pt, et)):
        assert _rel(a, b) < 1e-13
    for a, b in zip(j_geo.fundamental_frequencies_seconds(jnp.asarray(p), jnp.asarray(e), 1e6),
                    t_geo.fundamental_frequencies_seconds(pt, et, 1e6)):
        assert _rel(a, b) < 1e-13
    ref = j_geo.darwin_orbit(jnp.asarray(p[0]), jnp.asarray(e[0]))
    got = t_geo.darwin_orbit(pt[:1], et[:1])
    for key in ("r", "t", "phi"):
        a = np.asarray(ref[key])
        assert np.max(np.abs(a - got[key][0].numpy())) / np.max(np.abs(a)) < 1e-13, key
    for key in ("T_r", "Dphi"):
        assert _rel(ref[key], got[key][0]) < 1e-13


def test_pm_flux_balance_and_rhs(orbits):
    p, e = orbits
    pt, et = torch.from_numpy(p), torch.from_numpy(e)
    for a, b in zip(j_flux.pn_flux_e_l(jnp.asarray(p), jnp.asarray(e)), t_flux.pn_flux_e_l(pt, et)):
        assert _rel(a, b) < 1e-14
    ref = jax.vmap(j_flux.pdot_edot)(jnp.asarray(p), jnp.asarray(e))
    for a, b in zip(ref, t_flux.pdot_edot(pt, et)):
        assert _rel(a, b) < 1e-12
    state = np.stack([p, e, np.full_like(p, 1.0), np.full_like(p, 2.0)], axis=-1)
    nu = 5e-5
    ref = jax.vmap(lambda s: j_flux.inspiral_rhs(s, j_flux.InspiralRHS(nu=jnp.asarray(nu))))(
        jnp.asarray(state)
    )
    got = t_flux.inspiral_rhs(torch.from_numpy(state), torch.tensor(nu, dtype=torch.float64))
    assert _rel(ref, got) < 1e-12
    # forward-mode differentiable (the integrator's tail padding takes a jvp)
    _, tangent = torch.func.jvp(
        lambda s: t_flux.inspiral_rhs(s, torch.tensor(nu, dtype=torch.float64)),
        (torch.from_numpy(state),), (got,),
    )
    ref_t = jax.vmap(
        lambda s, v: jax.jvp(
            lambda y: j_flux.inspiral_rhs(y, j_flux.InspiralRHS(nu=jnp.asarray(nu))), (s,), (v,)
        )[1]
    )(jnp.asarray(state), ref)
    assert np.max(np.abs(np.asarray(ref_t) - tangent.numpy())) / np.max(np.abs(np.asarray(ref_t))) < 1e-10
    assert bool(t_flux.stop_condition(torch.tensor([[6.9, 0.4, 0.0, 0.0]]))[0])
    # the dissipative model is a function of (p, e) (or a flux grid, see
    # tests/test_torch_rwz.py): doubling the flux doubles (pdot, edot)
    twice = t_flux.inspiral_rhs(
        torch.from_numpy(state), torch.tensor(nu, dtype=torch.float64),
        lambda p_, e_: tuple(2.0 * x for x in t_flux.pn_flux_e_l(p_, e_)),
    )
    assert torch.allclose(twice[:, :2], 2.0 * got[:, :2], rtol=1e-14, atol=0.0)
    assert torch.equal(twice[:, 2:], got[:, 2:])


def _fixed_time_rel(t_a, y_a, t_b, y_b, t_fixed):
    """max |a - b| / max |a| of two knot series, each through its own
    not-a-knot spline, at common fixed times."""
    a = spline_eval(fit_cubic_spline(t_a, y_a, "not-a-knot"), t_fixed)
    b = spline_eval(fit_cubic_spline(t_b, y_b, "not-a-knot"), t_fixed)
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(a)))


@pytest.mark.parametrize(
    "p0, e0, t_years",
    # chirping lanes and a lane that plunges inside the horizon
    [((10.0, 12.0, 8.2), (0.4, 0.35, 0.1), 0.5), ((7.4, 11.0), (0.3, 0.3), 1.0)],
)
def test_dp5_inspiral_batch(p0, e0, t_years):
    # The knot sequences need not be identical: the step controller divides
    # a 1e-11-level error estimate, so last-bit differences of the RHS
    # (closed-form vs jacfwd Jacobian, libm) move later step sizes at the
    # ~1e-7 level and can add or drop a rejected step near the separatrix.
    # The solutions agree at fixed times.
    kw = dict(t_years=t_years, max_steps=256)
    got = t_insp.schwarz_ecc_flux_inspiral(
        1e6, 50.0, torch.tensor(p0, dtype=torch.float64), torch.tensor(e0, dtype=torch.float64),
        Phi_phi0=1.0, Phi_r0=2.0, **kw,
    )
    assert got.t.shape == (len(p0), 256)
    for i in range(len(p0)):
        ref = j_insp.schwarz_ecc_flux_inspiral(
            1e6, 50.0, p0[i], e0[i], Phi_phi0=1.0, Phi_r0=2.0, **kw
        )
        n, n_got = int(ref.n), int(got.n[i])
        assert abs(n_got - n) <= 3
        t_ref = torch.from_numpy(np.array(ref.t))
        t_end = min(float(ref.t[n - 1]), float(got.t[i, n_got - 1]))
        assert abs(float(ref.t[n - 1]) - float(got.t[i, n_got - 1])) < 1e-6 * t_end
        t_fixed = torch.linspace(0.0, t_end, 193, dtype=torch.float64)
        for field in ("Phi_phi", "Phi_r", "p", "e"):
            rel = _fixed_time_rel(
                t_ref, torch.from_numpy(np.array(getattr(ref, field))),
                got.t[i], getattr(got, field)[i], t_fixed,
            )
            assert rel < 1e-9, (field, rel)
        # the padding keeps time strictly increasing past the live knots
        assert torch.all(torch.diff(got.t[i]) > 0)
        # plunging lanes stop at the near-separatrix cutoff
        if n < 256 and t_end < 0.99 * t_years * 31558149.763545603:
            assert float(got.p[i, n_got - 1]) <= 6.0 + 2.0 * float(got.e[i, n_got - 1]) + 0.12


def test_get_p_at_t():
    kw = dict(n_iters=12, max_steps=256)
    ref = float(j_insp.get_p_at_t(1e6, 50.0, 0.3, 0.25, **kw))
    got = t_insp.get_p_at_t(1e6, 50.0, torch.tensor([0.3], dtype=torch.float64), 0.25, **kw)
    assert abs(float(got[0]) - ref) < 1e-12 * ref


def _rwz_grid():
    """The production rwz flux grid, as tabulated in float64 for the benchmark."""
    z = np.load(_REPO / "benchmark/reference/tables/flux_multipole_rwz.npz")
    return t_flux.FluxGrid(*(float(a) for a in z["axes"]), torch.as_tensor(z["values"]))


@pytest.mark.parametrize("case", ["pe", "wf"])
def test_dp5_wrapper_on_cpu_is_the_plain_loop(case):
    """On CPU tensors the dp5 trajectory (through `ops.dp5_inspiral`) is the
    plain batched loop to the bit, counts the plain loop's counters and
    launches no kernel, on a small PE batch (the production source) and a
    small batch of the waveform batch's draws, both under the rwz flux grid;
    the kernel path's tail, from the rate at the last knot, gives the plain
    tail's bits."""
    p0, e0 = ((9.528029 + 1e-4 * np.arange(3), np.full(3, 0.35)) if case == "pe" else
              (12.0 + 0.06 * np.arange(-1, 2), 0.35 + 0.015 * np.arange(-1, 2)))
    grid = _rwz_grid()
    flux_fn = t_insp.flux_model("multipole_rwz", "cpu", grid)
    m = torch.full((3,), 1e6, dtype=torch.float64)
    nu = 10.0 / m
    t_max = 0.02 * YRSID_SI / (m * MTSUN_SI)
    y0 = torch.as_tensor(np.stack([p0, e0, np.full(3, 1.0), np.full(3, 2.0)], axis=-1))
    plain = integrate_inspiral(
        lambda y: t_flux.inspiral_rhs(y, nu, flux_fn),
        lambda y: t_flux.stop_condition(y, 0.12),
        y0, t_max, max_steps=136, rtol=1e-11, tail_slope_mask=(0.0, 0.0, 1.0, 1.0),
    )
    launches = t_dp5.dp5_inspiral.launches
    tracing.reset()
    with tracing.enabled():
        traj = t_insp.schwarz_ecc_flux_inspiral(
            m, 10.0, y0[:, 0], y0[:, 1], t_years=0.02, Phi_phi0=1.0, Phi_r0=2.0,
            max_steps=136, flux="multipole_rwz", flux_grid=grid)
    counters = tracing.totals()
    tracing.reset()
    assert torch.equal(traj.n, plain.n) and torch.equal(traj.t, plain.t * (m * MTSUN_SI)[:, None])
    for field, col in (("p", 0), ("e", 1), ("Phi_phi", 2), ("Phi_r", 3)):
        assert torch.equal(getattr(traj, field), plain.y[..., col])
    assert t_dp5.dp5_inspiral.launches == launches
    assert "dp5.kernel_lanes" not in counters
    assert counters["dp5.lane_slots"] == 3 * counters["dp5.trips"] > 0
    assert counters["dp5.accepted"] == int(plain.n.sum()) - 3
    assert bool((plain.n < 136).all())
    last = plain.y[torch.arange(3), plain.n.long() - 1]
    tail = pad_knots(plain.t, plain.y, plain.n,
                     t_dp5.phase_slopes(t_flux.inspiral_rhs(last, nu, flux_fn)))
    assert all(torch.equal(a, b) for a, b in zip(tail, plain))
    with pytest.raises(ValueError, match="unsupported device"):
        t_dp5.dp5_inspiral(y0.to("meta"), t_max, nu, flux_fn, delta_p_stop=0.12,
                           max_steps=136, rtol=1e-11)


def test_dp5_kernel_order_constants():
    """The kernel's Darwin sums take `row_sum`'s one-warp order at the
    geodesic's node count: the wrapper's constants equal ops/row_ops.py's
    and the geodesic's, and so do the constants csrc/dp5_inspiral.cu states
    (the wrapper checks the kernel's own at load, on the card)."""
    assert (t_dp5.VECTOR_BYTES, t_dp5.SMALL_MAX) == (row_ops.VECTOR_BYTES, row_ops.SMALL_MAX)
    assert t_dp5.N_CHI == t_geo._N_CHI <= t_dp5.SMALL_MAX
    src = (_REPO / "emri_frequencydomainwaveforms_tpu_torch/csrc/dp5_inspiral.cu").read_text()
    stated = {k: int(v) for k, v in re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    assert (stated["kVecBytes"], stated["kSmallMax"], stated["kNChi"], stated["kWarp"]) == (
        t_dp5.VECTOR_BYTES, t_dp5.SMALL_MAX, t_dp5.N_CHI, WARP)


def test_darwin_sums_in_row_sum_order(orbits):
    """`testing/row_order.py::row_sum_order` of the Darwin integrands (n =
    256, float64) is the kernel's sum, replayed lane by lane (lane l adds
    the nodes j with (j // 2) % 32 == l in increasing j, then the xor
    butterfly), and the frequencies from it are `fundamental_frequencies`'s
    up to the CPU sum's order."""
    p, e = (torch.from_numpy(x) for x in orbits)
    h = 2.0 * np.pi / t_geo._N_CHI
    integrands = t_geo._darwin_integrands(p, e, t_geo._chi(t_geo._N_CHI, p))
    sums = []
    for x in integrands:
        acc = [torch.zeros(x.shape[0], dtype=torch.float64) for _ in range(WARP)]
        for j in range(x.shape[-1]):
            lane = (j // 2) % WARP
            acc[lane] = acc[lane] + x[:, j]
        off = WARP // 2
        while off:
            acc = [acc[lane] + acc[lane ^ off] for lane in range(WARP)]
            off //= 2
        assert all(torch.equal(a, acc[0]) for a in acc)
        assert torch.equal(acc[0], row_sum_order(x))
        sums.append(acc[0])
    dphi, t_r = sums[0] * h, sums[1] * h
    om_phi, om_r = t_geo.fundamental_frequencies(p, e)
    assert _rel(om_phi, dphi / t_r) < 1e-14
    assert _rel(om_r, t_r.reciprocal() * (2.0 * np.pi)) < 1e-14
