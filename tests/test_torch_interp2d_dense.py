"""The port's dense-cardinal bicubic path against its gather path.

Mirror of ``tests/test_interp2d_dense.py`` for the PyTorch port:
`interp2d_bicubic_dense` evaluates the same Catmull-Rom surface as the
4x4-stencil gather `interp2d_bicubic` (same indices, clamps and weights;
the two differ in reduction order only). Values for trailing channel shapes
(), (2,) and (3, 2), with interior, edge and far out-of-range queries (the
clamping must agree), at atol 1e-13; gradients through ``torch.autograd``
at atol 1e-12 (``tests/test_torch_rwz.py`` covers values only); a NaN off
the stencil never reaches the dense result; and the flux consumer
`multipole_flux_e_l(dense=True)` against ``dense=False`` on the port's own
rwz grid at rtol 1e-12.

The last case holds the port's gather path, values and gradients, to the
JAX package's on the same grid and queries: atol 1e-13 and 1e-12 (float64
in both, the same stencil arithmetic).
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.ops.interp2d import (
    interp2d_bicubic,
    interp2d_bicubic_dense,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mk(seed=0, nx=17, ny=11, channels=()):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((nx, ny) + channels)
    return 0.3, 0.11, -1.0, 0.07, torch.from_numpy(vals)


def _queries(x0, dx, y0, dy, nx, ny):
    """Interior, edge and far out-of-range queries (tests/test_interp2d_dense.py)."""
    rng = np.random.default_rng(2)
    xq = np.concatenate([
        x0 + dx * rng.uniform(0, nx - 1, 64),
        np.array([x0 - 5.0, x0, x0 + dx * (nx - 1), x0 + dx * nx + 7.0]),
    ])
    yq = np.concatenate([
        y0 + dy * rng.uniform(0, ny - 1, 64),
        np.array([y0 - 3.0, y0, y0 + dy * (ny - 1), y0 + dy * ny + 2.0]),
    ])
    return torch.from_numpy(xq), torch.from_numpy(yq)


def _grads(fn, x0, dx, y0, dy, vals, xq, yq):
    """d/d(xq, yq) of sum(fn(...)^2)."""
    x = xq.clone().requires_grad_(True)
    y = yq.clone().requires_grad_(True)
    s = torch.sum(fn(x0, dx, y0, dy, vals, x, y) ** 2)
    return torch.autograd.grad(s, (x, y))


GRAD_QUERIES = ([1.01, 1.3, 0.4, 2.2], [-0.7, -0.1, -0.5, -0.9])


@pytest.mark.parametrize("channels", [(), (2,), (3, 2)])
def test_dense_matches_gather_values(channels):
    x0, dx, y0, dy, vals = _mk(1, channels=channels)
    xq, yq = _queries(x0, dx, y0, dy, vals.shape[0], vals.shape[1])
    a = interp2d_bicubic(x0, dx, y0, dy, vals, xq, yq)
    b = interp2d_bicubic_dense(x0, dx, y0, dy, vals, xq, yq)
    assert a.shape == (len(xq),) + channels == b.shape
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)


def test_dense_matches_gather_grad():
    x0, dx, y0, dy, vals = _mk(3)
    xq, yq = (torch.tensor(v, dtype=torch.float64) for v in GRAD_QUERIES)
    ga = _grads(interp2d_bicubic, x0, dx, y0, dy, vals, xq, yq)
    gb = _grads(interp2d_bicubic_dense, x0, dx, y0, dy, vals, xq, yq)
    for a, b in zip(ga, gb):
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_dense_sanitizes_nonfinite_off_stencil():
    # 0 * nan in the dense contraction would poison every query: a
    # non-finite entry outside the 4x4 stencil must not reach the result
    x0, dx, y0, dy, vals = _mk(4)
    vals[-1, -1] = float("nan")
    xq = torch.tensor([x0 + 2.4 * dx], dtype=torch.float64)
    yq = torch.tensor([y0 + 2.6 * dy], dtype=torch.float64)
    a = interp2d_bicubic(x0, dx, y0, dy, vals, xq, yq)
    b = interp2d_bicubic_dense(x0, dx, y0, dy, vals, xq, yq)
    assert bool(torch.isfinite(b).all())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)


def test_flux_consumer_dense_gather_invariance():
    """Trajectory-level invariance: the flux via dense equals the flux via
    gather (tight), on the port's production rwz grid."""
    from emri_frequencydomainwaveforms_tpu_torch.models.flux import (
        default_flux_grid,
        multipole_flux_e_l,
    )

    grid = default_flux_grid(tail=True, factorized=True, rwz=True, device="cpu")
    rng = np.random.default_rng(5)
    p = torch.from_numpy(6.0 + 2.0 * 0.3 + np.exp(rng.uniform(np.log(0.05), np.log(8.0), 32)))
    e = torch.from_numpy(rng.uniform(0.0, 0.6, 32))
    de_g, dl_g = multipole_flux_e_l(p, e, grid=grid, dense=False)
    de_d, dl_d = multipole_flux_e_l(p, e, grid=grid, dense=True)
    assert bool(torch.isfinite(de_g).all() and torch.isfinite(dl_g).all())
    np.testing.assert_allclose(de_g.numpy(), de_d.numpy(), rtol=1e-12)
    np.testing.assert_allclose(dl_g.numpy(), dl_d.numpy(), rtol=1e-12)


def test_gather_values_and_grad_match_the_reference():
    import jax
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.ops.interp2d import interp2d_bicubic as j_interp

    x0, dx, y0, dy, vals = _mk(1, channels=(2,))
    xq, yq = _queries(x0, dx, y0, dy, vals.shape[0], vals.shape[1])
    ref = j_interp(x0, dx, y0, dy, jnp.asarray(vals.numpy()), jnp.asarray(xq.numpy()),
                   jnp.asarray(yq.numpy()))
    got = interp2d_bicubic(x0, dx, y0, dy, vals, xq, yq)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13)

    x0, dx, y0, dy, vals = _mk(3)
    xq, yq = (np.asarray(v) for v in GRAD_QUERIES)
    jv = jnp.asarray(vals.numpy())
    ref = jax.grad(lambda x, y: jnp.sum(j_interp(x0, dx, y0, dy, jv, x, y) ** 2),
                   argnums=(0, 1))(jnp.asarray(xq), jnp.asarray(yq))
    got = _grads(interp2d_bicubic, x0, dx, y0, dy, vals, torch.from_numpy(xq),
                 torch.from_numpy(yq))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-12)
