"""The order model of the fixed-order row kernels (``testing/row_order.py``).

The model replays, addition for addition, what ``csrc/row_ops.cu`` computes
on the card; the card tests (``tests/test_torch_row_ops.py``) hold the
kernels to it bit for bit. Here, on the CPU:

- the model equals a literal scalar transcription of the kernels' per-lane
  and per-thread code (numpy scalars, one addition at a time), so its
  vectorized indexing is the kernels' order;
- it agrees with ``torch.sum`` / ``torch.cumsum`` within the float order
  band (a sum of n terms within 2 n u sum|x|, element j of a running sum
  within 2 (j + 1) u sum_{j' <= j} |x_j'| of the float64 one, u the unit
  roundoff) at the PE path's widths: 256 chi nodes, 15,780 bins, a
  frequency shard of them, and both sides of the one-warp threshold;
- a row's result is bit-identical in batches of 1, 2, 3, 8 and 16 rows,
  and for the row sliced out of a larger tensor at an offset that breaks
  16-byte alignment or with an odd row stride.

Imports no JAX.
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.models.waveform import uniform_bins_per_run
from emri_frequencydomainwaveforms_tpu_torch.ops.row_ops import (
    CHUNK,
    SCAN_K,
    SCAN_THREADS,
    SMALL_MAX,
    VECTOR_BYTES,
)
from emri_frequencydomainwaveforms_tpu_torch.parallel.mesh import frequency_bounds
from emri_frequencydomainwaveforms_tpu_torch.testing.row_order import (
    row_cumsum_order,
    row_sum_order,
    sum_chunks,
)

NF = 15780  # the PE run's bins (PE_VALIDATION.md: 1 yr, downsample 100)
SHARD = frequency_bounds(NF, uniform_bins_per_run(NF), 2)[0][1]  # a 2-way frequency shard
WIDTHS = (256, SMALL_MAX, SMALL_MAX + 1, SHARD, NF)
DTYPES = (torch.float32, torch.float64)
BATCHES = (1, 2, 3, 8, 16)
UNIT = {torch.float32: 2.0**-24, torch.float64: 2.0**-53}


def _rows(n_rows, n, dtype, seed=3):
    """Mixed-sign rows with a drift, so that partial sums grow and cancel."""
    rng = np.random.default_rng(seed + n)
    x = rng.normal(size=(n_rows, n)) + rng.uniform(-0.5, 1.5, (n_rows, 1))
    return torch.as_tensor(x, dtype=dtype)


def _kernel_sum(row: np.ndarray, mean: bool):
    """``row_sum_kernel`` (+ ``row_sum_finish_kernel``) on one row, as the
    CUDA code reads, one numpy scalar addition at a time."""
    real = row.dtype.type
    n = len(row)

    def warp(seg):
        v = VECTOR_BYTES // seg.itemsize
        groups = len(seg) // v
        acc = [real(0)] * 32
        for lane in range(32):
            for g in range(lane, groups, 32):
                for i in range(v):
                    acc[lane] = acc[lane] + seg[g * v + i]
        if groups * v < len(seg):
            for j in range(groups * v, len(seg)):
                acc[groups % 32] = acc[groups % 32] + seg[j]
        off = 16
        while off:
            acc = [acc[lane] + acc[lane ^ off] for lane in range(32)]
            off //= 2
        return acc[0]

    scale = real(1.0 / n if mean else 1.0)
    if sum_chunks(n) == 1:
        return warp(row) * scale
    acc = real(0)
    for c in range(sum_chunks(n)):
        acc = acc + warp(row[c * CHUNK:(c + 1) * CHUNK])
    return acc * scale


def _kernel_cumsum(row: np.ndarray, k: int) -> np.ndarray:
    """``row_cumsum_kernel`` on one row, as the CUDA code reads, thread by
    thread."""
    real = row.dtype.type
    n, tile = len(row), SCAN_THREADS * k
    out = np.empty(n, row.dtype)
    carry = real(0)
    for base in range(0, n, tile):
        s = [row[base + j] if base + j < n else real(0) for j in range(tile)]
        local = []
        for t in range(SCAN_THREADS):
            v = s[t * k:(t + 1) * k]
            for i in range(1, k):
                v[i] = v[i - 1] + v[i]
            local.append(v)
        incl = [v[-1] for v in local]
        excl, warp_total = [real(0)] * SCAN_THREADS, []
        for w in range(SCAN_THREADS // 32):
            lanes = incl[32 * w:32 * (w + 1)]
            d = 1
            while d < 32:
                lanes = [lanes[i - d] + lanes[i] if i >= d else lanes[i] for i in range(32)]
                d *= 2
            for i in range(1, 32):
                excl[32 * w + i] = lanes[i - 1]
            warp_total.append(lanes[31])
        for t in range(SCAN_THREADS):
            before = total = real(0)
            for w in range(SCAN_THREADS // 32):
                if w == t // 32:
                    before = total
                total = total + warp_total[w]
            prefix = carry + (before + excl[t])
            for i in range(k):
                if base + t * k + i < n:
                    out[base + t * k + i] = prefix + local[t][i]
        carry = carry + total
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 37, 130, 256, SMALL_MAX, SMALL_MAX + 1, SMALL_MAX + CHUNK + 5])
def test_sum_model_is_the_kernel_code(n, dtype):
    x = _rows(2, n, dtype)
    for mean in (False, True):
        got = row_sum_order(x, mean=mean)
        for r in range(2):
            want = _kernel_sum(x[r].numpy(), mean)
            assert got[r].numpy().tobytes() == np.asarray(want).tobytes(), (n, mean, r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 29, 300, 2 * SCAN_THREADS * 8 + 77])
def test_cumsum_model_is_the_kernel_code(n, dtype):
    x = _rows(2, n, dtype)
    got = row_cumsum_order(x)
    for r in range(2):
        want = _kernel_cumsum(x[r].numpy(), SCAN_K[dtype])
        assert got[r].numpy().tobytes() == want.tobytes(), (n, r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_sum_model_within_the_order_band(n, dtype):
    x = _rows(6, n, dtype)
    exact = torch.sum(x.double(), -1)
    band = 2.0 * n * UNIT[dtype] * torch.sum(x.double().abs(), -1)
    assert bool(((row_sum_order(x).double() - exact).abs() <= band).all())
    assert bool(((row_sum_order(x, mean=True).double() - exact / n).abs()
                 <= band / n + 2.0 * UNIT[dtype] * exact.abs() / n).all())
    plain = torch.sum(x, -1).double()
    assert bool(((row_sum_order(x).double() - plain).abs() <= band).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", (256, SHARD, NF))
def test_cumsum_model_within_the_order_band(n, dtype):
    x = _rows(4, n, dtype)
    exact = torch.cumsum(x.double(), -1)
    terms = torch.arange(1, n + 1, dtype=torch.float64)
    band = 2.0 * terms * UNIT[dtype] * torch.cumsum(x.double().abs(), -1)
    assert bool(((row_cumsum_order(x).double() - exact).abs() <= band).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["row_sum", "row_mean", "row_cumsum"])
def test_model_rows_ignore_batch_and_layout(which, dtype):
    fn = {"row_sum": row_sum_order, "row_mean": lambda x: row_sum_order(x, mean=True),
          "row_cumsum": row_cumsum_order}[which]
    for n in ((256, SMALL_MAX + 1, NF) if which != "row_cumsum" else (256, NF)):
        x = _rows(16, n, dtype, seed=5)
        full = fn(x)
        for b in BATCHES:
            for k in (0, 5, 15):
                rows = [k] + [j for j in range(16) if j != k][: b - 1]
                assert torch.equal(fn(x[rows])[0], full[k]), (n, b, k)
        # one element past a 16-byte boundary, and an odd row stride
        flat = torch.zeros(16 * n + 3, dtype=dtype)
        flat[1:1 + 16 * n] = x.reshape(-1)
        shifted = flat[1:1 + 16 * n].view(16, n)
        assert shifted.storage_offset() * x.element_size() % VECTOR_BYTES != 0
        assert torch.equal(fn(shifted), full)
        wide = torch.zeros(16, n + 1, dtype=dtype)
        wide[:, :n] = x
        assert torch.equal(fn(wide[:, :n]), full)
        assert torch.equal(fn(wide[3:4, :n])[0], full[3])
