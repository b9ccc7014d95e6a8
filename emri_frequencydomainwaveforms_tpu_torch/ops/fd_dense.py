"""Banded FD dense pass: the hand-written CUDA kernel and its plain version.

Counterpart of the Pallas kernels in
``emri_frequencydomainwaveforms_tpu/ops/pallas/fd_dense.py``
(`fd_dense_accumulate`, `fd_dense_accumulate_batched`), implementing the
production superset the XLA dense pass computes
(``models/summation_fd.py::_dense_slot_accumulate``): per slot, over a
(g_band x r) window of uniform bins, evaluate the phase cubic plus the exact
integer-cycle term, the signed-modulus and envelope-phase cubics, one sin/cos
pair, mask to the slot's int32 band limits, weight by two complex weights and
accumulate into four float32 spectra at the slot's window offset.

The slots come in up to two groups (main slots, then the turnover / negative
extra slots with their own narrower window), each a `DenseGroup`. Bin
``g * r + b`` of a slot's window is output bin ``g0 * r + g * r + b``; a
window may start before the output (g0 < 0: a frequency shard's view of a
window that begins in an earlier shard) or end past it, and its bins outside
[0, nf) are dropped.

`fd_dense_accumulate` dispatches on the device of its tensors: CPU tensors
take the plain PyTorch version `fd_dense_accumulate_reference`; CUDA tensors
launch ``csrc/fd_dense.cu`` (built with nvcc at first use) or raise. There
is no fallback from the kernel to the plain version. Both return a (B, 4, nf)
view of a buffer with longer rows (the kernel's rows are padded to a
multiple of 32 bins, `output_buffer`), so a channel ``out[:, c]`` is a
strided (B, nf) tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils import tracing
from . import cuda_build

_TWO_PI = 2.0 * math.pi
_ROW_ALIGN = 32  # bins: 128-byte aligned float32 rows
_MAX_SLOTS = 512  # slots in all groups: the kernel's per-tile list is in shared memory
_MAX_BINS = 2**31 - 2**16  # bin indices and padded rows stay int32
_VECTOR_BYTES = 16  # pc, ec and w are read as float4


class DenseGroup(NamedTuple):
    """One group of slots of the dense pass (all tensors contiguous).

    pc: (B, S, G, 4) float32 phase cubic coefficients (2pi-cycle residuals).
    nc: (B, S, G, 3) int32 2pi-cycle counts of p1..p3 (zeros when r is not a
        power of two).
    ec: (B, S, G, 8) float32 signed-modulus cubic 0:4, envelope-phase cubic 4:8.
    i_lo, i_hi: (B, S) int32 first / last kept window-local bin; i_lo is
        INT32_MAX for a dead slot.
    w: (B, S, 4) float32 weights (w1r, w1i, w2r, w2i).
    g0: (B, S) int32 window start runs.
    """

    pc: torch.Tensor
    nc: torch.Tensor
    ec: torch.Tensor
    i_lo: torch.Tensor
    i_hi: torch.Tensor
    w: torch.Tensor
    g0: torch.Tensor


def _cycle_scale(r: int) -> float:
    return float(np.float32(_TWO_PI / (r * r * r)))


def _slot_contribution(grp: DenseGroup, s: int, r: int):
    """(B, 4, G * r) weighted, band-masked contribution of slot ``s``."""
    f32 = torch.float32
    dev = grp.pc.device
    n_g = grp.pc.shape[2]
    pc = grp.pc[:, s]  # (B, G, 4)
    nc = grp.nc[:, s]
    ec = grp.ec[:, s]
    xi = (torch.arange(r, dtype=f32, device=dev) * float(np.float32(1.0 / r)))[None, None, :]
    psi = pc[..., 0:1] + xi * (pc[..., 1:2] + xi * (pc[..., 2:3] + xi * pc[..., 3:4]))
    # exact integer-cycle phase, int32 Horner chain reduced mod r^3
    mask = r * r * r - 1
    b = torch.arange(r, dtype=torch.int32, device=dev)[None, None, :]
    n1, n2, n3 = nc[..., 0:1], nc[..., 1:2], nc[..., 2:3]
    u = torch.bitwise_and(b * n3, mask)
    u = torch.bitwise_and(r * n2 + u, mask)
    u = torch.bitwise_and(b * u, mask)
    u = torch.bitwise_and(r * r * n1 + u, mask)
    u = torch.bitwise_and(b * u, mask)
    psi = psi + u.to(f32) * _cycle_scale(r)
    amp = ec[..., 0:1] + xi * (ec[..., 1:2] + xi * (ec[..., 2:3] + xi * ec[..., 3:4]))
    psi = psi + ec[..., 4:5] + xi * (ec[..., 5:6] + xi * (ec[..., 6:7] + xi * ec[..., 7:8]))
    c_re = amp * torch.cos(psi)
    c_im = amp * torch.sin(psi)
    idx_local = (
        torch.arange(n_g, dtype=torch.int32, device=dev)[:, None] * r
        + torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    )[None]
    keep = (idx_local >= grp.i_lo[:, s, None, None]) & (idx_local <= grp.i_hi[:, s, None, None])
    # a select, not a multiply: masked lanes may hold NaN
    zero = torch.zeros((), dtype=f32, device=dev)
    c_re = torch.where(keep, c_re, zero).reshape(c_re.shape[0], -1)
    c_im = torch.where(keep, c_im, zero).reshape(c_im.shape[0], -1)
    w = grp.w[:, s, :, None]
    return torch.stack(
        [
            c_re * w[:, 0] - c_im * w[:, 1],
            c_re * w[:, 1] + c_im * w[:, 0],
            c_re * w[:, 2] - c_im * w[:, 3],
            c_re * w[:, 3] + c_im * w[:, 2],
        ],
        dim=1,
    )


def fd_dense_accumulate_reference(
    groups: Sequence[DenseGroup], *, r: int, nf: int
) -> torch.Tensor:
    """Plain PyTorch dense pass -> (B, 4, nf) float32.

    A per-slot windowed add in slot order (group by group), the same float
    operations in the same order as the reference's read-modify-write chain.
    Window bins past ``nf`` land in a discarded spill bin.
    """
    pc0 = groups[0].pc
    n_b, dev = pc0.shape[0], pc0.device
    out = torch.zeros((n_b, 4, nf + 1), dtype=torch.float32, device=dev)
    for grp in groups:
        n_g = grp.pc.shape[2]
        local = torch.arange(n_g * r, device=dev)
        for s in range(grp.pc.shape[1]):
            pos = grp.g0[:, s, None].long() * r + local[None, :]  # (B, G r)
            pos = torch.where((pos >= 0) & (pos < nf), pos, nf)
            out.scatter_add_(2, pos[:, None, :].expand(n_b, 4, -1), _slot_contribution(grp, s, r))
    return out[..., :nf]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build("fd_dense")[0])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    group = [p, p, p, p, p, p, p, i, i]
    lib.fd_dense_launch.argtypes = group + group + [p, i, i, i, i, f, f, p]
    lib.fd_dense_launch.restype = ctypes.c_int
    return lib


def padded_bins(nf: int) -> int:
    """Row length of the kernel's output buffer: nf rounded up to a multiple
    of 32 bins, so every row starts 128-byte aligned and takes float4 stores."""
    return -(-nf // _ROW_ALIGN) * _ROW_ALIGN


def output_buffer(n_b: int, nf: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(buffer (B, 4, padded_bins(nf)), its (B, 4, nf) view) in float32.

    The kernel writes the whole buffer (pad columns hold zeros); callers get
    the view, whose channel rows ``view[:, c]`` are strided (B, nf) tensors.
    """
    buf = torch.empty((n_b, 4, padded_bins(nf)), dtype=torch.float32, device=device)
    return buf, buf[..., :nf]


def _check_group(grp: DenseGroup, n_b: int, dev: torch.device) -> None:
    n_s, n_g = grp.pc.shape[1], grp.pc.shape[2]
    shapes = {
        "pc": ((n_b, n_s, n_g, 4), torch.float32),
        "nc": ((n_b, n_s, n_g, 3), torch.int32),
        "ec": ((n_b, n_s, n_g, 8), torch.float32),
        "i_lo": ((n_b, n_s), torch.int32),
        "i_hi": ((n_b, n_s), torch.int32),
        "w": ((n_b, n_s, 4), torch.float32),
        "g0": ((n_b, n_s), torch.int32),
    }
    for name, (shape, dtype) in shapes.items():
        t = getattr(grp, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be a contiguous tensor on {dev}")
    for name in ("pc", "ec", "w"):
        if getattr(grp, name).data_ptr() % _VECTOR_BYTES:
            raise ValueError(f"{name}: the kernel reads it as float4; its data must start "
                             f"{_VECTOR_BYTES}-byte aligned")


def check_call(groups: Sequence[DenseGroup], *, r: int, nf: int) -> None:
    """Raise ValueError unless the kernel can take these tables: one or two
    groups of contiguous tensors on one device, of the `DenseGroup` shapes
    and dtypes, with pc, ec and w 16-byte aligned; 1 <= r <= 128; at most
    512 slots in all; B <= 65535 and nf < 2^31 - 2^16."""
    if not 1 <= len(groups) <= 2:
        raise ValueError("fd_dense_accumulate takes one or two slot groups")
    if not 1 <= r <= 128:
        # the int32 cycle chain stays below 2^30 only for r <= 128
        raise ValueError(f"bins per run r={r} outside [1, 128]")
    n_b = groups[0].pc.shape[0]
    if not 1 <= n_b <= 65535 or not 1 <= nf <= _MAX_BINS:
        raise ValueError(f"batch {n_b} outside [1, 65535] or grid nf={nf} outside [1, {_MAX_BINS}]")
    if sum(grp.pc.shape[1] for grp in groups) > _MAX_SLOTS:
        # the per-tile slot list lives in shared memory
        raise ValueError(f"more than {_MAX_SLOTS} slots in all")
    for grp in groups:
        _check_group(grp, n_b, groups[0].pc.device)


def fd_dense_accumulate(groups: Sequence[DenseGroup], *, r: int, nf: int) -> torch.Tensor:
    """Dense pass over one or two slot groups -> (B, 4, nf) float32.

    CPU tensors run `fd_dense_accumulate_reference`. CUDA tensors are held to
    `check_call`, then launch the kernel on the current stream (no
    synchronisation; the output is the only allocation) and count the launch
    in ``fd_dense_accumulate.launches``. The result is the (B, 4, nf) view of
    `output_buffer`'s padded rows.
    """
    dev = groups[0].pc.device
    if dev.type == "cpu":
        return fd_dense_accumulate_reference(groups, r=r, nf=nf)
    if dev.type != "cuda":
        raise ValueError(f"fd_dense_accumulate: unsupported device {dev}")
    check_call(groups, r=r, nf=nf)
    n_b = groups[0].pc.shape[0]
    buf, out = output_buffer(n_b, nf, dev)

    def args(grp: DenseGroup | None):
        if grp is None:
            return [None] * 7 + [0, 0]
        return [t.data_ptr() for t in grp] + [grp.pc.shape[1], grp.pc.shape[2]]

    extra = groups[1] if len(groups) > 1 else None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fd_dense_launch(
            *args(groups[0]), *args(extra), buf.data_ptr(), n_b, nf, buf.shape[2], r,
            float(np.float32(1.0 / r)), _cycle_scale(r),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fd_dense kernel launch failed: cudaError {err}")
    fd_dense_accumulate.launches += 1
    tracing.count("fd_dense.launches")
    return out


fd_dense_accumulate.launches = 0

__all__ = [
    "DenseGroup",
    "fd_dense_accumulate",
    "fd_dense_accumulate_reference",
    "check_call",
    "output_buffer",
    "padded_bins",
]
