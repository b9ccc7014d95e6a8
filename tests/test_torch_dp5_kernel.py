"""The dp5 trajectory kernel (``csrc/dp5_inspiral.cu``) on the card.

Every test here needs an NVIDIA GPU (marked ``cuda``; each skips without
one: the kernel has no CPU mode). This file imports no JAX, so it runs on
the GPU machine:

    python -m pytest tests/test_torch_dp5_kernel.py --noconftest -q

* the kernel's right-hand side against `flux.inspiral_rhs` on the card, to
  the bit, under the Peters-Mathews flux and the production rwz flux grid;
* the kernel against the plain version on the card (`ops.dp5_inspiral`'s
  `dp5_inspiral_reference`) at the PE shape (64 lanes, 512 steps), the
  waveform batch's (128 lanes, 192 steps) and on Peters-Mathews lanes: the
  same knot counts, and knots equal to the bit or, where a last-bit
  difference moved a step, within 1e-9 at fixed times;
* one lane alone equals the same lane inside the 128-lane batch, to the bit;
* the counters: ``dp5.kernel_lanes`` = B x calls, the loop's counters hold
  against the knots, ``dp5_inspiral.launches`` counts each call;
* the wrapper raises for a flux model the kernel does not take.
"""

import pathlib

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.models.flux import FluxGrid, inspiral_rhs, pn_flux_e_l
from emri_frequencydomainwaveforms_tpu_torch.ops import dp5_inspiral as dp5
from emri_frequencydomainwaveforms_tpu_torch.ops.cubic_spline import fit_cubic_spline, spline_eval
from emri_frequencydomainwaveforms_tpu_torch.utils import tracing
from emri_frequencydomainwaveforms_tpu_torch.utils.constants import MTSUN_SI, YRSID_SI

_TABLE = (pathlib.Path(__file__).resolve().parents[1]
          / "benchmark/reference/tables/flux_multipole_rwz.npz")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dp5 kernel has no CPU mode")
    return torch.device("cuda", 0)


def _grid(dev):
    """The production rwz flux grid, tabulated in float64 (the benchmark's)."""
    z = np.load(_TABLE)
    return FluxGrid(*(float(a) for a in z["axes"]), torch.as_tensor(z["values"], device=dev))


def _lanes(dev, n_b, p0, dp, e0, de, seed):
    """(y0, t_max, nu) of n_b 1-yr lanes of M = 1e6, mu = 10 around (p0, e0)."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(p0 + dp * rng.standard_normal(n_b), device=dev)
    e = torch.as_tensor(e0 + de * rng.standard_normal(n_b), device=dev)
    m = torch.full_like(p, 1e6)
    y0 = torch.stack([p, e, torch.zeros_like(p), torch.zeros_like(p)], dim=-1)
    return y0, 1.0 * YRSID_SI / (m * MTSUN_SI), 10.0 / m


# (name, lanes, max_steps, flux): the PE call, the waveform batch, Peters-Mathews
CASES = [
    ("pe", (64, 9.528029, 1e-4, 0.35, 1e-4, 1), 512, "rwz"),
    ("wf", (128, 12.0, 0.06, 0.35, 0.015, 2), 192, "rwz"),
    ("pm", (64, 11.0, 0.5, 0.3, 0.05, 3), 512, "pm"),
]


@pytest.mark.cuda
def test_cuda_rhs_equals_the_plain_rhs_to_the_bit(card):
    rng = np.random.default_rng(5)
    n = 4096
    e = rng.uniform(0.0, 0.75, n)
    e[:8] = 0.0  # the clamp of e away from 0
    p = 6.0 + 2.0 * e + rng.uniform(0.13, 10.0, n)
    y = torch.as_tensor(np.stack([p, e, rng.uniform(0, 1e6, n), rng.uniform(0, 1e6, n)], -1),
                        device=card)
    nu = torch.as_tensor(rng.uniform(1e-6, 1e-4, n), device=card)
    for flux_fn in (pn_flux_e_l, _grid(card)):
        got, ref = dp5.dp5_rhs(y, nu, flux_fn), inspiral_rhs(y, nu, flux_fn)
        assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_the_plain_version(card, case):
    name, lanes, max_steps, flux = case
    flux_fn = _grid(card) if flux == "rwz" else pn_flux_e_l
    y0, t_max, nu = _lanes(card, *lanes)
    kw = dict(delta_p_stop=0.12, max_steps=max_steps, rtol=1e-11)
    launches = dp5.dp5_inspiral.launches
    got = dp5.dp5_inspiral(y0, t_max, nu, flux_fn, **kw)
    ref = dp5.dp5_inspiral_reference(y0, t_max, nu, flux_fn, **kw)
    torch.cuda.synchronize()
    assert dp5.dp5_inspiral.launches == launches + 1
    assert torch.equal(got.n, ref.n)
    same = [bool(torch.equal(got.t[i], ref.t[i]) and torch.equal(got.y[i], ref.y[i]))
            for i in range(y0.shape[0])]
    print(f"[dp5] {name}: {sum(same)} of {len(same)} lanes equal the plain version to the bit")
    for i in (i for i, s in enumerate(same) if not s):
        # a last-bit difference that moved a step: the same solution
        n = int(got.n[i])
        t_fixed = torch.linspace(0.0, float(got.t[i, n - 1]), 193, dtype=torch.float64,
                                 device=card)
        for col in range(4):
            a = spline_eval(fit_cubic_spline(ref.t[i], ref.y[i, :, col], "not-a-knot"), t_fixed)
            b = spline_eval(fit_cubic_spline(got.t[i], got.y[i, :, col], "not-a-knot"), t_fixed)
            assert float((a - b).abs().max() / a.abs().max()) < 1e-9, (i, col)
    assert torch.all(torch.diff(got.t, dim=1) > 0)


@pytest.mark.cuda
def test_cuda_lane_alone_equals_it_in_the_batch(card):
    flux_fn = _grid(card)
    y0, t_max, nu = _lanes(card, *CASES[1][1])
    kw = dict(delta_p_stop=0.12, max_steps=192, rtol=1e-11)
    batch = dp5.dp5_inspiral(y0, t_max, nu, flux_fn, **kw)
    for i in (0, 77, 127):
        one = dp5.dp5_inspiral(y0[i:i + 1], t_max[i:i + 1], nu[i:i + 1], flux_fn, **kw)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, batch))


@pytest.mark.cuda
def test_cuda_counters(card):
    """``dp5.kernel_lanes`` counts B per call (B x calls in all); the loop's
    counters hold against the knots and, where the knots are the plain
    loop's, equal its counters (the same step sequences)."""
    flux_fn = _grid(card)
    y0, t_max, nu = _lanes(card, *CASES[0][1])
    kw = dict(delta_p_stop=0.12, max_steps=512, rtol=1e-11)

    def traced(fn, lanes):
        tracing.reset()
        with tracing.enabled():
            out = fn(y0[lanes], t_max[lanes], nu[lanes], flux_fn, **kw)
        counters = tracing.totals()
        tracing.reset()
        return out, counters

    (got, c), (five, c5) = (traced(dp5.dp5_inspiral, s) for s in (slice(None), slice(0, 5)))
    ref, plain = traced(dp5.dp5_inspiral_reference, slice(None))
    assert (c["dp5.kernel_lanes"], c5["dp5.kernel_lanes"]) == (64, 5)
    assert "dp5.kernel_lanes" not in plain
    for out, n_b, cc in ((got, 64, c), (five, 5, c5)):
        assert cc["dp5.accepted"] == int(out.n.sum()) - n_b
        assert cc["dp5.accepted"] + cc["dp5.rejected"] <= cc["dp5.lane_slots"]
        assert cc["dp5.lane_slots"] == n_b * cc["dp5.trips"]
    if all(torch.equal(a, b) for a, b in zip(got, ref)):
        for key in ("dp5.trips", "dp5.lane_slots", "dp5.accepted", "dp5.rejected"):
            assert c[key] == plain[key], key


@pytest.mark.cuda
def test_cuda_wrapper_refuses_other_flux_models(card):
    y0, t_max, nu = _lanes(card, 2, 10.0, 0.1, 0.3, 0.01, 4)
    kw = dict(delta_p_stop=0.12, max_steps=16, rtol=1e-11)
    with pytest.raises(ValueError, match="pn_flux_e_l or a FluxGrid"):
        dp5.dp5_inspiral(y0, t_max, nu, lambda p, e: pn_flux_e_l(p, e), **kw)
    grid = _grid(card)
    with pytest.raises(ValueError, match="float64"):
        dp5.dp5_inspiral(y0, t_max, nu, grid._replace(values=grid.values.float()), **kw)
    with pytest.raises(ValueError, match="float64"):
        dp5.dp5_inspiral(y0.float(), t_max, nu, grid, **kw)
