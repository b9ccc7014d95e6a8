"""Walker and frequency sharding over ``torch.distributed``.

Counterpart of ``emri_frequencydomainwaveforms_tpu.parallel.mesh``. The
scaling axes are the same:

* **walkers** (data parallel): each rank evaluates the likelihood of its
  contiguous shard of the walker rows; the ensemble itself is replicated
  (every rank holds every walker and draws the same proposals from an
  identically seeded generator), so only likelihood rows cross ranks;
* **frequency**: FD bins are independent given the per-mode spline data, so
  each rank on the frequency axis computes only its contiguous bin range,
  cut on run boundaries (`frequency_range`), and a sum over bins is taken
  shard by shard: the inner sum per shard, the shards' partial sums added
  in rank order (`ordered_sum`), as a single-process replay that reshapes
  the bins the same way adds them.

The JAX package leaves the distribution to ``jax.jit`` under
``NamedSharding`` constraints. Here it is spelled out: `walker_mesh` /
`composed_mesh` build a ``DeviceMesh`` over the initialized process group,
`shard_walkers`, `replicated` and `shard_frequency` give the DTensor
placements that stand for ``P(axis)``, ``P()`` and ``P(None, axis)``,
`shard_range` is the piece of an axis a rank owns under those placements,
and `gather_shards` all-gathers the pieces in rank order (through
``DTensor.full_tensor``). Each rank computes on ``cuda:(rank %
device_count)`` unless the caller names a device (`rank_device`).

The communication backend is an explicit argument of `run_ranks`. NCCL
takes one GPU per rank; with several ranks on one GPU the ranks compute on
that GPU and exchange their small gathered tensors (log L rows, partial
sums, spectra) through ``gloo`` on the host. Ranks meet through a
``FileStore`` in a temporary directory, so no network port is opened.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

_CALL = "call.pt"
_RESULT = "rank0.pt"


def _mesh_device_type() -> str:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: start the ranks with "
                           "run_ranks (or dist.init_process_group) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def walker_mesh(n_devices: int | None = None, axis: str = "walkers") -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``axis`` over ranks ``0 .. n_devices - 1``
    of the initialized process group (all of it when ``n_devices`` is None).

    Raises when there is no process group or it has fewer than
    ``n_devices`` ranks. Every rank of the group must call it.
    """
    device_type = _mesh_device_type()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"walker_mesh: {n} devices asked of a process group of {world}")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def composed_mesh(n_walkers: int, n_freq: int,
                  axes: tuple[str, str] = ("walkers", "freq")) -> DeviceMesh:
    """A 2-D (``n_walkers`` x ``n_freq``) ``DeviceMesh`` over the first
    ``n_walkers * n_freq`` ranks, rank ``w * n_freq + f`` at (w, f)."""
    device_type = _mesh_device_type()
    world = dist.get_world_size()
    if not 1 <= n_walkers * n_freq <= world:
        raise ValueError(f"composed_mesh: {n_walkers} x {n_freq} devices asked of a process "
                         f"group of {world}")
    ranks = torch.arange(n_walkers * n_freq).reshape(n_walkers, n_freq)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def _placements(mesh: DeviceMesh, axis: str, shard) -> list:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    return [shard if name == axis else Replicate() for name in names]


def shard_walkers(mesh: DeviceMesh, axis: str = "walkers") -> list:
    """Placements of (nwalkers, ...) arrays: the leading axis split over the
    mesh axis ``axis`` (``P(axis)``)."""
    return _placements(mesh, axis, Shard(0))


def replicated(mesh: DeviceMesh) -> list:
    """Placements of an array every rank holds whole (``P()``)."""
    return [Replicate()] * mesh.ndim


def shard_frequency(mesh: DeviceMesh, axis: str = "walkers") -> list:
    """Placements of (..., Nf) spectra: the second axis split over the mesh
    axis ``axis`` (``P(None, axis)``)."""
    return _placements(mesh, axis, Shard(1))


def _axis_index(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis' size)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    dim = names.index(axis)
    return coord[dim], mesh.size(dim)


def shard_bounds(n: int, size: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``size`` shards of ``n`` indices: contiguous pieces
    of ceil(n / size) in order, as ``Shard`` splits a dimension (trailing
    shards may hold fewer, or none)."""
    chunk = -(-n // size)
    return [(min(k * chunk, n), min((k + 1) * chunk, n)) for k in range(size)]


def frequency_bounds(nf: int, bins_per_run: int, size: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``size`` frequency shards of ``nf`` uniform bins:
    `shard_bounds` over the ceil(nf / bins_per_run) runs, in bins, so that
    every boundary is a run boundary (the last shard may be ragged). A
    single-process replay sums its bins in these pieces."""
    runs = shard_bounds(-(-nf // bins_per_run), size)
    return [(min(lo * bins_per_run, nf), min(hi * bins_per_run, nf)) for lo, hi in runs]


def shard_range(n: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """This rank's `shard_bounds` piece of ``n`` indices along ``axis``."""
    idx, size = _axis_index(mesh, axis)
    return shard_bounds(n, size)[idx]


def frequency_range(nf: int, bins_per_run: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """This rank's `frequency_bounds` piece of ``nf`` bins along ``axis``."""
    idx, size = _axis_index(mesh, axis)
    return frequency_bounds(nf, bins_per_run, size)[idx]


def gather_shards(local: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int,
                  size: int) -> torch.Tensor:
    """The whole tensor, on every rank, from each rank's `shard_range` piece
    of dimension ``dim`` (``size`` long in all) along ``axis``, in rank order.

    The pieces cross ranks on the mesh's device type (the host under gloo)
    and the result comes back to ``local``'s device.
    """
    dim = dim % local.dim()
    shape = list(local.shape)
    shape[dim] = size
    stride = torch.empty(shape, device="meta").stride()
    placements = _placements(mesh, axis, Shard(dim))
    host = local.to(mesh.device_type).contiguous()
    full = DTensor.from_local(host, mesh, placements, shape=tuple(shape), stride=stride,
                              run_check=False)
    return full.full_tensor().to(local.device)


def gather_frequency(local: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int, nf: int,
                     bins_per_run: int) -> torch.Tensor:
    """The whole grid of ``nf`` bins along dimension ``dim``, on every rank,
    from each rank's `frequency_range` piece along ``axis``: the pieces are
    padded to the widest shard, gathered in rank order and cut to ``nf``."""
    dim = dim % local.dim()
    _, size = _axis_index(mesh, axis)
    lo, hi = frequency_bounds(nf, bins_per_run, size)[0]
    width = hi - lo
    pad = list(local.shape)
    pad[dim] = width - local.shape[dim]
    padded = torch.cat([local, local.new_zeros(pad)], dim=dim)
    return gather_shards(padded, mesh, axis, dim, width * size).narrow(dim, 0, nf)


def ordered_sum(parts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` adding the slices in index order (part 0, then 1,
    ...): the outer, shard-hierarchical half of a frequency-sharded sum,
    the same on every rank and in a single-process replay."""
    out = parts.select(dim, 0)
    for k in range(1, parts.shape[dim]):
        out = out + parts.select(dim, k)
    return out


def walker_sharded(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   mesh: DeviceMesh, axis: str = "walkers") -> torch.Tensor:
    """``fn(x)`` computed by walker shards: this rank evaluates ``fn`` on its
    `shard_range` of ``x``'s leading rows, and the values are all-gathered
    in rank order. ``x`` is replicated (every rank passes the same rows);
    ``fn`` maps (m, ...) rows to (m,) float64 values; a rank whose shard is
    empty does not call it."""
    lo, hi = shard_range(x.shape[0], mesh, axis)
    local = fn(x[lo:hi]) if hi > lo else torch.empty(0, dtype=torch.float64)
    return gather_shards(local, mesh, axis, 0, x.shape[0])


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: ``device`` when given, else
    ``cuda:(rank % device_count)``; raises without a CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to compute the ranks on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, run_dir: str, backend: str) -> None:
    # one intra-op thread per rank: ranks that share a host's cores would
    # otherwise each start a thread per core
    torch.set_num_threads(1)
    fn, args = torch.load(os.path.join(run_dir, _CALL), weights_only=False)
    store = dist.FileStore(os.path.join(run_dir, "store"), world)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, os.path.join(run_dir, _RESULT))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class RankRun:
    """Ranks running ``fn(*args)`` in the background (`start_ranks`);
    `join` waits for them and returns rank 0's result."""

    def __init__(self, fn: Callable, n_ranks: int, args: Sequence, backend: str):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: expected 'gloo' or 'nccl'")
        self.run_dir = tempfile.mkdtemp(prefix="emri_ranks_")
        try:
            # the call goes through a file: spawn pipes each process its
            # arguments, and past the pipe's buffer the parent waits for each
            # child to import its modules before starting the next
            torch.save((fn, tuple(args)), os.path.join(self.run_dir, _CALL))
            self.context = mp.start_processes(
                _rank_main, args=(n_ranks, self.run_dir, backend), nprocs=n_ranks, join=False,
                start_method="spawn")
        except BaseException:
            shutil.rmtree(self.run_dir, ignore_errors=True)
            raise

    def join(self):
        """Wait for every rank; rank 0's result. A failure in any rank
        raises here, after the others are stopped."""
        try:
            while not self.context.join():
                pass
            return torch.load(os.path.join(self.run_dir, _RESULT), weights_only=False)
        finally:
            shutil.rmtree(self.run_dir, ignore_errors=True)


def start_ranks(fn: Callable, n_ranks: int, args: Sequence = (), *, backend: str) -> RankRun:
    """Spawn ``n_ranks`` processes that join one process group (``backend``:
    "gloo" or "nccl"; a ``FileStore`` rendezvous in a temporary directory)
    and call ``fn(*args)`` in each, with one intra-op CPU thread; return at
    once. The caller may compute meanwhile, then `RankRun.join`.

    ``fn`` and ``args`` must pickle (a module-level function).
    """
    return RankRun(fn, n_ranks, args, backend)


def run_ranks(fn: Callable, n_ranks: int, args: Sequence = (), *, backend: str):
    """`start_ranks` and join: rank 0's result, every process ended."""
    return start_ranks(fn, n_ranks, args, backend=backend).join()


__all__ = [
    "walker_mesh",
    "composed_mesh",
    "shard_walkers",
    "replicated",
    "shard_frequency",
    "shard_bounds",
    "frequency_bounds",
    "shard_range",
    "frequency_range",
    "gather_shards",
    "gather_frequency",
    "ordered_sum",
    "walker_sharded",
    "rank_device",
    "RankRun",
    "start_ranks",
    "run_ranks",
]
