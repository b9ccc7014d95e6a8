"""A walker's row does not depend on the batch it is evaluated in.

Every formulation the port routes through the fixed-order row kernels
(``ops/row_ops.py``: the RHS's fundamental frequencies, the amplitudes'
sums over the chi nodes, the level-1 envelope phase's running sum, the
likelihood's sum over bins) or through batched products (the amplitudes'
antiderivative, one product per row, and projection) gives bit-identical
rows for walker batches of 1, 2, 3, 8 and 16, with one and with four CPU
threads; on the CPU the wrappers run their plain versions. On the card
(marked ``cuda``: skips without a GPU) the kernels are held to their plain
versions, the float32 running sum at the PE path's width to a float64 one
element by element, the kernels and the batched products to the same row
invariance, and ``row_sum`` to its forward-mode derivative; and each kernel
is held bit for bit to its order model (``testing/row_order.py``) at every
call site's shape, on both sides of ``row_sum``'s one-warp threshold, and
on rows that start off a 16-byte boundary or lie at an odd stride.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_row_ops.py --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood import Likelihood
from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import (
    _products,
    default_mode_table,
    mode_amplitudes,
)
from emri_frequencydomainwaveforms_tpu_torch.models.geodesic import fundamental_frequencies
from emri_frequencydomainwaveforms_tpu_torch.models.summation_fd import _polar_envelope
from emri_frequencydomainwaveforms_tpu_torch.ops import row_ops
from emri_frequencydomainwaveforms_tpu_torch.testing.row_order import (
    row_cumsum_order,
    row_sum_order,
)

BATCHES = (1, 2, 3, 8, 16)
N = 16


def _inputs():
    rng = np.random.default_rng(21)
    p = torch.as_tensor(rng.uniform(8.0, 14.0, (N, 12)))
    e = torch.as_tensor(rng.uniform(0.05, 0.6, (N, 12)))
    phase = torch.as_tensor(np.cumsum(rng.uniform(-1.0, 1.0, (N, 6, 700)), axis=-1))
    amp = torch.as_tensor(rng.uniform(0.5, 2.0, (N, 6, 700)))
    x = torch.as_tensor(rng.normal(size=(N, 3000)))
    a = torch.as_tensor(rng.normal(size=(N, 40, 256)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(256, 256)), dtype=torch.float32)
    wb = torch.as_tensor(rng.normal(size=(N, 256, 9)), dtype=torch.float32)
    return p, e, phase, amp, x, a, w, wb


def _likelihood_rows(x):
    nf = x.shape[-1]
    like = Likelihood(lambda full: [(x[full[:, 0].long()], x[full[:, 0].long()] * 0.5)], 1,
                      f_arr=np.linspace(1e-3, 2e-3, nf), device="cpu")
    like.inject_signal([np.linspace(0.0, 1.0, nf) + 1j * np.linspace(1.0, 0.0, nf)],
                       noise_fn=lambda f: np.ones_like(f))
    return lambda rows: like(torch.as_tensor(rows, dtype=torch.float64)[:, None])


def _formulations():
    p, e, phase, amp, x, a, w, wb = _inputs()
    table = default_mode_table(3, l_max=3)
    like_rows = _likelihood_rows(x)
    return {
        "fundamental_frequencies": lambda r: fundamental_frequencies(p[r], e[r]),
        "mode_amplitudes": lambda r: mode_amplitudes(p[r], e[r], table),
        "polar_envelope": lambda r: _polar_envelope(amp[r] * torch.cos(phase[r]),
                                                    amp[r] * torch.sin(phase[r])),
        "likelihood": like_rows,
        "row_sum": lambda r: row_ops.row_sum(x[r]),
        "row_mean": lambda r: row_ops.row_sum(x[r], mean=True),
        "row_cumsum": lambda r: row_ops.row_cumsum(x[r]),
        "antiderivative_rows": lambda r: _products(a[r].reshape(-1, 1, 256), w).reshape(
            len(r), -1),
        "projection_bmm": lambda r: _products(a[r], wb[r]),
    }


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("name", sorted(_formulations()))
def test_rows_do_not_depend_on_the_batch(name, threads):
    fn = _formulations()[name]
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        full = _flat(fn(list(range(N))))
        for b in BATCHES:
            for k in (0, 5, N - 1):
                rows = [k] + [j for j in range(N) if j != k][: b - 1]
                got = _flat(fn(rows))
                for g, f in zip(got, full):
                    assert torch.equal(g[0], f[k]), (name, b, k)
    finally:
        torch.set_num_threads(saved)


def test_cpu_dispatch_is_the_plain_version():
    _, _, _, _, x, a, w, wb = _inputs()
    before = (row_ops.row_sum.launches, row_ops.row_cumsum.launches)
    assert torch.equal(row_ops.row_sum(x), torch.sum(x, dim=-1))
    assert torch.equal(row_ops.row_sum(x, mean=True), torch.mean(x, dim=-1))
    assert torch.equal(row_ops.row_cumsum(x), torch.cumsum(x, dim=-1))
    assert before == (row_ops.row_sum.launches, row_ops.row_cumsum.launches)
    # the amplitudes' products: torch.matmul on the CPU, a GEMM for a shared w
    assert torch.equal(_products(a.reshape(-1, 1, 256), w)[:, 0], a.reshape(-1, 256) @ w)
    assert torch.equal(_products(a, wb), torch.bmm(a, wb))
    # forward mode through the plain version, as the trajectory's pad takes it
    val, tan = torch.func.jvp(row_ops.row_sum, (x,), (torch.ones_like(x),))
    assert torch.equal(val, torch.sum(x, dim=-1))
    assert torch.all(tan == x.shape[-1])
    with pytest.raises(ValueError):
        row_ops.row_sum(x.to("meta"))
    with pytest.raises(ValueError):
        row_ops.row_cumsum(x.to("meta"))


@pytest.mark.cuda
def test_cuda_row_kernels_match_plain_and_ignore_the_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, _, phase, _, x, a, w, wb = _inputs()
    dev = torch.device("cuda", 0)
    x, a, w, wb, ph = (t.to(dev) for t in (x, a, w, wb, phase))
    before = row_ops.row_sum.launches
    a2 = a.reshape(-1, 256)
    # (rows -> the function on those rows, its plain version on all rows,
    # the number of rows, the tolerance relative to the largest value)
    cases = [
        (lambda r: row_ops.row_sum(x[r]), lambda: torch.sum(x, -1), N, 1e-13),
        (lambda r: row_ops.row_sum(x[r], mean=True), lambda: torch.mean(x, -1), N, 1e-13),
        (lambda r: row_ops.row_sum(a[r]), lambda: torch.sum(a, -1), N, 1e-5),
        (lambda r: row_ops.row_cumsum(ph[r]), lambda: torch.cumsum(ph, -1), N, 1e-12),
        (lambda r: _products(a2[r][:, None], w)[:, 0], lambda: a2 @ w, a2.shape[0], 1e-5),
        (lambda r: _products(a[r], wb[r]), lambda: torch.matmul(a, wb), N, 1e-5),
    ]
    for fn, plain, n, tol in cases:
        got, ref = fn(list(range(n))), plain()
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
        for b in BATCHES:
            assert torch.equal(fn([5] + list(range(b - 1)))[0], got[5])
    # past one chunk of items: each item as in a call of its own
    wbig = wb.repeat(40, 1, 1)
    many = _products(a2[:, None], wbig)
    for r in (1, 192, 600):
        assert torch.equal(_products(a2[r - 1:r, None], wbig[r - 1:r])[0], many[r - 1])
    assert row_ops.row_sum.launches > before
    val, tan = torch.func.jvp(row_ops.row_sum, (x,), (torch.ones_like(x),))
    assert torch.equal(val, row_ops.row_sum(x))
    assert torch.all(tan == x.shape[-1])


@pytest.mark.cuda
def test_cuda_float32_running_sum_at_the_pe_width():
    """The level-1 envelope phase's float32 running sum at the PE path's
    width (48 slots x 15,780 bins per walker), each element within
    2 (j + 1) u sum_{j' <= j} |x_j'| of the float64 running sum of its
    first j + 1 terms: a scan that drops or shifts one term fails at the
    first element it touches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.uniform(-1.0, 2.0, (4, 48, 15780)), dtype=torch.float32)
    got = row_ops.row_cumsum(x.to("cuda")).cpu().double()
    exact = torch.cumsum(x.double(), -1)
    terms = torch.arange(1, x.shape[-1] + 1, dtype=torch.float64)
    bound = 2.0 * terms * 2.0**-24 * torch.cumsum(x.double().abs(), -1)
    assert bool(((got - exact).abs() <= bound).all())


# (kernel, rows, n, dtype): the PE path's call sites ([rhs], [amplitudes],
# [likelihood], [level-1] and the stage report's float64 running sum), a
# 2-way frequency shard of the 15,780 bins, and row_sum's threshold's sides
MODEL_CASES = [
    ("row_sum", 64, 256, torch.float64),
    ("row_sum", 32768, 256, torch.float32),
    ("row_sum", 64, 15780, torch.float64),
    ("row_sum", 64, 7890, torch.float64),
    ("row_sum", 64, row_ops.SMALL_MAX, torch.float32),
    ("row_sum", 64, row_ops.SMALL_MAX + 1, torch.float32),
    ("row_sum", 64, row_ops.SMALL_MAX, torch.float64),
    ("row_sum", 64, row_ops.SMALL_MAX + 1, torch.float64),
    ("row_cumsum", 64 * 48, 15780, torch.float32),
    ("row_cumsum", 16 * 48, 15780, torch.float64),
    ("row_cumsum", 64, 2 * row_ops.SCAN_THREADS * 8 + 77, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{str(c[3]).split('.')[-1]}")
def test_cuda_row_kernels_equal_the_order_model(case):
    """Each kernel's bits are the order model's, for contiguous rows, rows
    one element off a 16-byte boundary, rows at an odd stride, and a few
    rows alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    name, n_rows, n, dtype = case
    rng = np.random.default_rng(n_rows + n)
    x = torch.as_tensor(rng.normal(size=(n_rows, n)) + rng.uniform(-0.5, 1.5, (n_rows, 1)),
                        dtype=dtype).to("cuda")
    fns = ([(row_ops.row_cumsum, row_cumsum_order)] if name == "row_cumsum" else
           [(row_ops.row_sum, row_sum_order),
            (lambda t: row_ops.row_sum(t, mean=True), lambda t: row_sum_order(t, mean=True))])
    flat = torch.zeros(n_rows * n + 3, dtype=dtype, device="cuda")
    flat[1:1 + n_rows * n] = x.reshape(-1)
    shifted = flat[1:1 + n_rows * n].view(n_rows, n)
    wide = torch.zeros(n_rows, n + 1, dtype=dtype, device="cuda")
    wide[:, :n] = x
    for kernel, model in fns:
        want = model(x)
        for layout in (x, shifted, wide[:, :n]):
            got = kernel(layout)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, n_rows, n, dtype)
        for rows in ([5], [7, 1, 2]):
            assert torch.equal(kernel(shifted[rows])[0], want[rows[0]])
            assert torch.equal(kernel(wide[rows, :n])[0], want[rows[0]])
