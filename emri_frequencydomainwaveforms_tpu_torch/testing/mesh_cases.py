"""The JAX package's sharding tests (``tests/test_parallel.py``) as one
rank's work on a `parallel.mesh` process group, for the CPU tests.

`reference_cases` runs, on a walker mesh over every rank: the tiny
likelihood of those tests by walker shards (with each walker's live knots),
the `shard_walkers` and `replicated` placements, the mean log L by
per-rank partial sums (the ``psum`` pattern), the tiny waveform generated by
frequency shards and whole, and one stretch-move step with its log L
evaluated by walker shards, on draws the caller gives. Rank 0's results go
back to the caller (`run_ranks`).
"""

from __future__ import annotations

import numpy as np
import torch

# the reference tests' tiny model
F0, DF, NF = 1e-3, 3e-7, 256
L_MAX = 2


def generate(p0: torch.Tensor, device="cpu", bins=None):
    """The four (n, bins) spectra and the live knots of the tiny waveform at
    the (n,) initial semi-latus recta ``p0``."""
    from ..models.amplitude import default_mode_table
    from ..models.waveform import fd_waveform_core, waveform_prologue

    table = default_mode_table(4, l_max=L_MAX)
    pro = waveform_prologue(
        1e6, 10.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=0.005, table=table, k_max=8, eps=1e-2, max_steps=64, device=device,
    )
    out = fd_waveform_core(pro, table, NF, channels=True, uniform=(F0, DF), bin_range=bins)
    return out, pro.n_live


def log_like(p0: torch.Tensor, device="cpu"):
    """(log L, live knots) of the tiny likelihood: -1/2 sum |h|^2 1e34."""
    from ..ops.row_ops import row_sum

    out, n_live = generate(p0, device)
    return -0.5 * sum(row_sum(o * o) for o in out) * 1e34, n_live


def gaussian_ll(x: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(x * x, dim=-1)


def reference_cases(p0s: np.ndarray, coords: np.ndarray, betas: np.ndarray, draws) -> dict:
    """One rank's part of the mirrored tests (see the module docstring).

    ``p0s`` (n,): the walkers of the tiny likelihood; ``coords`` (ntemps,
    nwalkers, ndim), ``betas`` and the stretch ``draws`` (`StretchMove.draws`
    layout) of the sampler step, whose log L is the unit Gaussian.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor

    from ..inference.moves.stretch import StretchMove
    from ..models.waveform import uniform_bins_per_run
    from ..parallel.mesh import (frequency_range, gather_frequency, gather_shards, replicated,
                                 shard_frequency, shard_range, shard_walkers, walker_mesh,
                                 walker_sharded)

    mesh = walker_mesh()
    world = dist.get_world_size()
    p0 = torch.as_tensor(p0s)
    n = p0.shape[0]
    lo, hi = shard_range(n, mesh, "walkers")
    ll_loc, knots_loc = log_like(p0[lo:hi])
    out = dict(ll=gather_shards(ll_loc, mesh, "walkers", 0, n),
               n_live=gather_shards(knots_loc, mesh, "walkers", 0, n))
    # the mean by per-rank partial sums, reduced across ranks
    part = DTensor.from_local(torch.sum(ll_loc)[None], mesh, [Partial()])
    out["mean"] = part.full_tensor()[0] / n
    # placements
    xs = distribute_tensor(torch.zeros((16, 6), dtype=torch.float64), mesh, shard_walkers(mesh))
    out["shard_local_shape"] = tuple(xs.to_local().shape)
    out["shard_placements"] = [(type(p).__name__, getattr(p, "dim", None)) for p in xs.placements]
    xr = distribute_tensor(torch.arange(8.0, dtype=torch.float64), mesh, replicated(mesh))
    out["replicated_local"] = xr.to_local().clone()
    out["replicated_all"] = all(p.is_replicate() for p in xr.placements)
    xf = distribute_tensor(torch.zeros((4, NF), dtype=torch.float64), mesh, shard_frequency(mesh))
    out["frequency_local_shape"] = tuple(xf.to_local().shape)
    out["frequency_placements"] = [(type(p).__name__, getattr(p, "dim", None))
                                   for p in xf.placements]
    # the waveform by frequency shards (each rank its bins) and whole
    r = uniform_bins_per_run(NF)
    bins = frequency_range(NF, r, mesh, "walkers")
    shard, _ = generate(torch.tensor([10.0], dtype=torch.float64), bins=bins)
    out["gen_sharded"] = gather_frequency(torch.stack(shard)[:, 0], mesh, "walkers", 1, NF, r)
    whole, _ = generate(torch.tensor([10.0], dtype=torch.float64))
    out["gen_whole"] = torch.stack(whole)[:, 0]
    # one stretch step, log L by walker shards
    c = torch.as_tensor(coords)
    b = torch.as_tensor(betas)
    ll0, lp0 = gaussian_ll(c), torch.zeros(c.shape[:-1], dtype=torch.float64)

    def logp(x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype)

    step = StretchMove().step(c, ll0, lp0, b, draws, logp,
                              lambda x: walker_sharded(gaussian_ll, x, mesh))
    out["step_coords"], out["step_ll"], out["step_accepted"] = step[0], step[1], step[3]
    out["world"] = world
    return out


__all__ = ["generate", "log_like", "gaussian_ll", "reference_cases", "F0", "DF", "NF"]
