"""Row sums and running sums whose result for a row does not depend on the
batch: the fixed-order CUDA kernels of ``csrc/row_ops.cu`` and their plain
versions.

PyTorch's CUDA reductions pick their launch configuration from the whole
tensor, so the order in which one row is summed, and with it the row's last
bits, follows the number of rows. The adaptive dp5 trajectory amplifies
that into another step sequence, so a walker's waveform and log L followed
the batch it was evaluated in. Every reduction of the PE path that rounds
by batch goes through these wrappers instead (`testing/batch_dependence.py`
finds them and checks the result; the amplitudes' products take cuBLAS's
batched product instead, `models/amplitude.py::_products`). They
replace no TPU kernel.

Each wrapper dispatches on the device of its input: CPU tensors take the
plain version (``torch.sum`` / ``torch.mean`` / ``torch.cumsum``, which do
not depend on the batch on the CPU), CUDA tensors launch the kernel (built
with nvcc at first use) or raise. Each launch adds one to the wrapper's
``launches``. `row_sum` carries a forward-mode derivative (the row sum of
the tangent), since the trajectory takes a ``torch.func.jvp`` through its
right-hand side.

The kernels' order of additions is set by the row length and the dtype
through the constants below (the kernel's own are checked against them when
the library loads); `testing/row_order.py` replays it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import tracing
from . import cuda_build

VECTOR_BYTES = 16  # a lane's load: 4 float32 or 2 float64 consecutive elements
SMALL_MAX = 2048  # row_sum: n <= SMALL_MAX, one warp per row
CHUNK = 512  # row_sum: n > SMALL_MAX, one warp per CHUNK elements, then chunk order
SCAN_THREADS = 256  # row_cumsum: threads per row; a tile is SCAN_THREADS * SCAN_K elements
SCAN_K = {torch.float32: 8, torch.float64: 4}


@functools.lru_cache(maxsize=None)
def _load() -> dict:
    """Build and load ``csrc/row_ops.cu``: {dtype: (row_sum fn, row_cumsum fn)}."""
    lib = ctypes.CDLL(cuda_build.build("row_ops")[0])
    lib.row_ops_constants.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.row_ops_constants.restype = None
    got = (ctypes.c_longlong * 6)()
    lib.row_ops_constants(got)
    want = (VECTOR_BYTES, SMALL_MAX, CHUNK, SCAN_THREADS, SCAN_K[torch.float32],
            SCAN_K[torch.float64])
    if tuple(got) != want:
        raise RuntimeError(f"csrc/row_ops.cu's order constants {tuple(got)} differ from "
                           f"ops/row_ops.py's {want}")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    kernels = {}
    for dt, suffix, real in ((torch.float64, "f64", ctypes.c_double),
                             (torch.float32, "f32", ctypes.c_float)):
        rs, rc = getattr(lib, f"row_sum_{suffix}"), getattr(lib, f"row_cumsum_{suffix}")
        rs.argtypes = [p, p, ll, ll, ll, real, p]
        rc.argtypes = [p, p, ll, ll, ll, p]
        rs.restype = rc.restype = ctypes.c_int
        kernels[dt] = (rs, rc)
    return kernels


def _kernels(dtype: torch.dtype):
    """The typed C entry points for ``dtype`` (built and loaded at first use)."""
    if dtype not in SCAN_K:
        raise ValueError(f"expected a float32 or float64 tensor, got {dtype}")
    return _load()[dtype]


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """``x`` as rows with unit element stride: (tensor, row count, row stride)."""
    n = x.shape[-1]
    if x.is_contiguous():
        return x, x.numel() // n, n
    rows = x.reshape(-1, n)
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    return rows, rows.shape[0], rows.stride(0)


def _launch_row_sum(x: torch.Tensor, mean: bool) -> torch.Tensor:
    # the RHS calls this twice per evaluation, ~10^5 times per PE run: the
    # host path is kept short (one allocation, one ctypes call, the raw
    # stream without a Stream object, the device switched only when it is
    # not current)
    fn = _kernels(x.dtype)[0]
    index = x.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return _launch_row_sum(x, mean)
    n = x.shape[-1]
    out = x.new_empty(x.shape[:-1])
    if out.numel() == 0 or n == 0:
        return out.zero_()
    rows, n_rows, ld = (x, out.numel(), n) if x.is_contiguous() else _rows(x)
    err = fn(rows.data_ptr(), out.data_ptr(), n_rows, n, ld, 1.0 / n if mean else 1.0,
             torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"row_sum kernel launch failed: cudaError {err}")
    row_sum.launches += 1
    tracing.count("row_sum.launches")
    return out


class _RowSum(torch.autograd.Function):
    """The kernel with its forward-mode derivative (linear: the row sum of
    the tangent) and its reverse-mode one (the cotangent broadcast)."""

    @staticmethod
    def forward(x, mean):
        return _launch_row_sum(x, mean)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mean = inputs[1]
        ctx.shape = inputs[0].shape

    @staticmethod
    def jvp(ctx, x_t, _):
        # through apply, not the launch: under torch.func.jvp the tangent is
        # a wrapper without storage, which apply unwraps
        return _RowSum.apply(x_t, ctx.mean)

    @staticmethod
    def backward(ctx, g):
        n = ctx.shape[-1]
        g = g[..., None].expand(ctx.shape)
        return (g / n if ctx.mean else g), None


def row_sum(x: torch.Tensor, mean: bool = False) -> torch.Tensor:
    """Sum (``mean=True``: mean) over the last axis, each row in an order
    fixed by its length and dtype alone.

    CPU: ``torch.sum(x, -1)`` / ``torch.mean(x, -1)``. CUDA (float32 or
    float64): up to `SMALL_MAX` elements one warp per row, each lane adding
    its 16-byte groups in order, then a fixed butterfly; longer rows in
    chunks of `CHUNK` elements summed so, their partials added in chunk
    order (``csrc/row_ops.cu``). A mean is the sum times 1 / n.
    """
    if x.is_cuda:
        if x.requires_grad or torch._C._are_functorch_transforms_active():
            return _RowSum.apply(x, mean)
        # no autograd.Function (~25 us of host time a call) where no
        # derivative is taken
        return _launch_row_sum(x, mean)
    if x.device.type == "cpu":
        return torch.mean(x, dim=-1) if mean else torch.sum(x, dim=-1)
    raise ValueError(f"row_sum: unsupported device {x.device}")


row_sum.launches = 0


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis, each row in an order fixed by its
    length and dtype alone.

    CPU: ``torch.cumsum(x, -1)``. CUDA (float32 or float64): one block per
    row, in tiles of `SCAN_THREADS` x `SCAN_K` elements: each thread's
    elements in order, a fixed scan of the thread and warp totals, the
    tiles' carry in order (``csrc/row_ops.cu``).
    """
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=-1)
    if x.device.type != "cuda":
        raise ValueError(f"row_cumsum: unsupported device {x.device}")
    fn = _kernels(x.dtype)[1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rows, n_rows, ld = _rows(x)
        err = fn(rows.data_ptr(), out.data_ptr(), n_rows, x.shape[-1], ld,
                 torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"row_cumsum kernel launch failed: cudaError {err}")
    row_cumsum.launches += 1
    tracing.count("row_cumsum.launches")
    return out


row_cumsum.launches = 0


__all__ = ["row_sum", "row_cumsum"]
