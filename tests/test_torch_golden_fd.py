"""The port's FD construction against the notebook's scipy SPA pipeline.

Mirror of ``tests/test_golden_fd.py`` for the PyTorch port: the same golden
source (M = 1e6, mu = 50, p0 = 10, e0 = 0.4), the same forced modes, the
same 4096-bin band trimmed a bin inside each edge, the same thresholds. The
truth (`testing/truth.py`, a copy of the reference test's helpers held to
them in ``tests/test_torch_truth_copies.py``) shares only the port's
trajectory knots and Ylm weights with the port's kernel, so agreement
validates the port's FD construction itself, not its agreement with JAX.

The last case carries the JAX package's own 1-yr prologue into the port and
holds the port's general kernel to the JAX kernel on it: relative L2
<= 1e-5 (float32 sin/cos and accumulation in both) and the golden mismatch
on those knots within 1e-9 of JAX's. On its own knots the port reads a
larger 1-yr mismatch than JAX on JAX's (4.5e-6 against 2.2e-6): the dp5
step sequences differ by seconds from the sixth knot on (a reference
behaviour: adaptive steps), and the mismatch of sparse-knot SPA follows the
knot placement; on JAX's knots the port reads JAX's value.
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.testing import truth
from emri_frequencydomainwaveforms_tpu_torch.testing.truth_cases import golden_case


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [((2, 2, 0), 0.25), ((2, 2, 3), 0.25), ((2, 2, -1), 0.25), ((2, 0, 3), 0.25),
         ((2, 2, 0), 1.0)]


def _run_case(mode, t_years, gate=1e-4):
    case = golden_case(mode, t_years, device="cpu")
    golden, ours = case["golden"], case["ours"]
    assert np.isfinite(golden).all() and np.isfinite(ours).all()
    mm = case["mm"]
    print(f"port golden {mode} {t_years} yr: Hann mismatch {mm:.4e}, interior median "
          f"{case['median_rel']:.4e}")
    assert mm < gate, f"golden mismatch {mm:.3e} over gate {gate:g} for {mode}"
    # pointwise agreement over the band interior (the two t(f) inversions
    # differ at spline-representation level near the edges)
    assert case["median_rel"] < 1e-3, f"median pointwise rel err {case['median_rel']:.3e}"
    return mm


@pytest.mark.parametrize("mode", [(2, 2, 0), (2, 2, 3), (2, 2, -1)])
def test_quarter_year(mode):
    _run_case(mode, t_years=0.25)


def test_one_year_gate():
    # the 1e-4 gate at the full 1-yr configuration, single mode; the port
    # reads 4.5e-6 Hann-weighted on its own knots (JAX 2.2e-6 on its own)
    mm = _run_case((2, 2, 0), t_years=1.0, gate=1e-4)
    # the reference's tighter sanity bound
    assert mm < 1e-5, f"1-yr golden mismatch degraded to {mm:.3e}"


def test_m0_mode():
    # m = 0, n = 3: pure radial harmonic, the d_n (r^2) branch
    _run_case((2, 0, 3), t_years=0.25)


def test_one_year_on_the_reference_knots():
    """The JAX package's 1-yr prologue through both packages' general
    kernels, each beside the same golden pipeline; first the reference
    test's own cases through the JAX package (printed with ``-s``, to be
    read beside the card's values that ``chip_smoke.py``'s ``[truth]``
    prints)."""
    import jax
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu.models.modeselect import table_indices_for
    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        fd_waveform_core as j_core,
        waveform_prologue as j_prologue,
    )
    from emri_frequencydomainwaveforms_tpu_torch import convert
    from emri_frequencydomainwaveforms_tpu_torch.models.waveform import fd_waveform_core
    from emri_frequencydomainwaveforms_tpu_torch.testing.truth_cases import GOLDEN_SOURCE
    from tests.test_golden_fd import _run_case as j_run_case

    for mode, t_years in CASES:
        print(f"JAX golden {mode} {t_years} yr: Hann mismatch {j_run_case(mode, t_years):.4e}")
    table = default_mode_table(30, l_max=2)
    forced = table_indices_for(table, [(2, 2, 0)])
    pro = j_prologue(*GOLDEN_SOURCE, t_years=1.0, table=table, k_max=1, eps=1e-2,
                     forced_idx=forced)
    n = int(pro.n_live)
    t = np.asarray(pro.t_knots)[:n]
    phase = 2.0 * np.asarray(pro.phi_phi)[:n]
    idx = int(forced[0])
    ym = np.asarray(pro.y_minus[0])[idx] + 1j * np.asarray(pro.y_minus[1])[idx]
    f_grid = truth.golden_grid(t, phase, 4096)
    golden = truth.golden_fd_positive(
        t, phase, np.asarray(pro.a_re)[:n, idx], np.asarray(pro.a_im)[:n, idx], ym, f_grid
    ) * float(pro.dist_factor)

    o = j_core(pro, table, jnp.asarray(f_grid), channels=False)
    ref = np.asarray(o[0]) + 1j * np.asarray(o[1])
    pro_t = convert.prologue_from_numpy(jax.tree_util.tree_map(np.asarray, pro), device="cpu")
    o = fd_waveform_core(pro_t, convert.mode_table_from_numpy(*table), torch.from_numpy(f_grid),
                         channels=False)
    got = o[0][0].numpy() + 1j * o[1][0].numpy()
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)
    hann = np.hanning(len(f_grid))
    mm_ref, mm_got = truth.mismatch(golden, ref, hann), truth.mismatch(golden, got, hann)
    assert mm_ref < 1e-5 and abs(mm_got - mm_ref) < 1e-9
