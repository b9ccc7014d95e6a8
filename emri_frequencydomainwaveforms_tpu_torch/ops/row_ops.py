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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build("row_ops")[0])
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.row_sum_f64.argtypes = [p, p, ll, ll, ll, ctypes.c_double, p]
    lib.row_sum_f32.argtypes = [p, p, ll, ll, ll, ctypes.c_float, p]
    lib.row_cumsum_f64.argtypes = [p, p, ll, ll, ll, p]
    lib.row_cumsum_f32.argtypes = [p, p, ll, ll, ll, p]
    for fn in (lib.row_sum_f64, lib.row_sum_f32, lib.row_cumsum_f64, lib.row_cumsum_f32):
        fn.restype = ctypes.c_int
    return lib


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"{name}: every tensor must lie on {dev}")
        if x.dtype not in _SUFFIX or x.dtype != xs[0].dtype:
            raise ValueError(f"{name}: expected float32 or float64 tensors of one dtype, "
                             f"got {[t.dtype for t in xs]}")


def _launch_row_sum(x: torch.Tensor, mean: bool) -> torch.Tensor:
    _check_cuda("row_sum", x)
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    if n > 0 and rows.stride(-1) != 1:
        rows = rows.contiguous()
    out = torch.empty(rows.shape[0], dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0 or n == 0:
        return out.zero_().reshape(x.shape[:-1])
    scale = 1.0 / n if mean else 1.0
    fn = getattr(_library(), f"row_sum_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), out.data_ptr(), rows.shape[0], n, rows.stride(0), scale,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_sum kernel launch failed: cudaError {err}")
    row_sum.launches += 1
    return out.reshape(x.shape[:-1])


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
    fixed by its length alone.

    CPU: ``torch.sum(x, -1)`` / ``torch.mean(x, -1)``. CUDA (float32 or
    float64): one block per row, each thread adding a strided slice in
    order, then a fixed tree (``csrc/row_ops.cu``); a mean is the sum times
    1 / n.
    """
    if x.device.type == "cpu":
        return torch.mean(x, dim=-1) if mean else torch.sum(x, dim=-1)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum: unsupported device {x.device}")
    if x.requires_grad or torch._C._are_functorch_transforms_active():
        return _RowSum.apply(x, mean)
    # the dp5 RHS calls this twice per evaluation: no autograd.Function
    # (~25 us of host time a call) where no derivative is taken
    return _launch_row_sum(x, mean)


row_sum.launches = 0


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis, each row in an order fixed by its
    length alone.

    CPU: ``torch.cumsum(x, -1)``. CUDA (float32 or float64): one block per
    row, each thread a contiguous chunk in order, the chunks' offsets added
    in order (``csrc/row_ops.cu``).
    """
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=-1)
    if x.device.type != "cuda":
        raise ValueError(f"row_cumsum: unsupported device {x.device}")
    _check_cuda("row_cumsum", x)
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    if n > 0 and rows.stride(-1) != 1:
        rows = rows.contiguous()
    out = torch.empty(rows.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    fn = getattr(_library(), f"row_cumsum_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), out.data_ptr(), rows.shape[0], n, rows.stride(0),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_cumsum kernel launch failed: cudaError {err}")
    row_cumsum.launches += 1
    return out.reshape(x.shape)


row_cumsum.launches = 0


__all__ = ["row_sum", "row_cumsum"]
