"""`testing/truth.py` and `testing/truth_cases.py` against the reference
test suite's own helpers, so that the port's yardstick cannot drift from
the one the JAX package is held to.

Each copy runs beside the helper it copies (imported from
``tests/test_golden_fd.py``, ``tests/test_turnover.py`` and
``tests/test_real_fold.py``) on the same inputs: the numpy / scipy copies
bit for bit; the synthetic fold's kernel inputs, whose splines each package
fits with its own tridiagonal solve, field by field within 1e-15 of each
field's largest magnitude; `truth.cubic_eval`, which stands in for the JAX
``spline_eval`` in the real fold's brute-force integral, within 1e-15 of it.
"""

import numpy as np
import pytest

from emri_frequencydomainwaveforms_tpu_torch.models.modeselect import table_indices_for
from emri_frequencydomainwaveforms_tpu_torch.testing import truth
from emri_frequencydomainwaveforms_tpu_torch.testing import truth_cases as cases


@pytest.fixture(scope="module")
def golden_inputs():
    """The knots, amplitude and weight of the golden (2,2,0) case at
    0.25 yr through the port, and its trimmed band."""
    case = cases.golden_case((2, 2, 0), 0.25, device="cpu")
    pro, table = case["pro"], case["table"]
    idx = int(table_indices_for(table, [(2, 2, 0)])[0])
    n = int(pro.n_live[0])
    t = pro.t_knots[0, :n].numpy()
    phase = 2.0 * pro.phi_phi[0, :n].numpy()
    ym = complex(pro.y_minus[0][0, idx]) + 1j * complex(pro.y_minus[1][0, idx])
    return (t, phase, pro.a_re[0, :n, idx].numpy(), pro.a_im[0, :n, idx].numpy(), ym,
            case["f_grid"])


def test_golden_fd_positive_is_the_reference(golden_inputs):
    from tests.test_golden_fd import _golden_fd_positive

    ref = _golden_fd_positive(*golden_inputs)
    got = truth.golden_fd_positive(*golden_inputs)
    assert np.isfinite(ref).all() and np.array_equal(got, ref)


def test_mismatch_is_the_reference(golden_inputs):
    from tests.test_golden_fd import _golden_fd_positive, _mismatch

    a = _golden_fd_positive(*golden_inputs)
    rng = np.random.default_rng(12)
    b = a * (1.0 + 1e-3 * rng.standard_normal(len(a))) * np.exp(1e-2j * rng.standard_normal(len(a)))
    for w in (None, np.hanning(len(a))):
        assert truth.mismatch(a, b, w) == _mismatch(a, b, w)
        assert 0.0 < _mismatch(a, b, w) < 1e-3


def test_synthetic_fold_inputs_are_the_reference():
    from tests.test_turnover import _synthetic_fold_inputs

    ref, ref_params = _synthetic_fold_inputs()
    got, params = cases.synthetic_fold_inputs(device="cpu")
    assert params == ref_params
    for name, a, b in zip(ref._fields, ref, got):
        a, b = np.asarray(a), b[0].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = float(np.abs(a).max()) if a.size else 0.0
        assert float(np.abs(a - b).max(initial=0.0)) <= 1e-15 * scale, name
    t, phi = truth.synthetic_fold_knots(*ref_params)
    assert np.array_equal(t, np.asarray(ref.t_knots))
    assert np.array_equal(phi[:-1], np.asarray(ref.c_phi_phi)[:, 0])


def test_taper_and_rms_are_the_reference():
    from tests.test_real_fold import _rms, _taper

    t_end, t_fold = 9.5e5, 6.0e5
    tt = np.linspace(-1e4, 1.1e6, 4001)
    assert np.array_equal(truth.taper(tt, t_end, t_fold), _taper(tt, t_end, t_fold))
    rng = np.random.default_rng(13)
    bv = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    case = dict(bv=bv, scale=float(np.sqrt(np.mean(np.abs(bv) ** 2))))
    k = bv + 0.05 * (rng.standard_normal(12) + 1j * rng.standard_normal(12))
    assert truth.rms(k, case) == _rms(k, case) > 0


def test_cubic_eval_is_the_reference_spline_eval():
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import (
        CubicSplineCoeffs,
        fit_cubic_spline,
        spline_eval,
    )

    rng = np.random.default_rng(14)
    x = np.cumsum(rng.uniform(1e3, 1e5, 60))
    y = np.sin(x / 3e5) * 1e3 + rng.standard_normal(60)
    sp = fit_cubic_spline(jnp.asarray(x), jnp.asarray(y), bc="not-a-knot")
    # inside, on the knots and past both ends (the clamped end segments)
    xq = np.concatenate([rng.uniform(x[0], x[-1], 500), x, [x[0] - 5e3, x[-1] + 5e3]])
    ref = np.asarray(spline_eval(CubicSplineCoeffs(x=sp.x, c=sp.c), jnp.asarray(xq)))
    got = truth.cubic_eval(x, np.asarray(sp.c), xq)
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()
