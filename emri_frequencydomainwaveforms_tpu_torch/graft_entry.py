"""Entry points of the port: the flagship forward and the multi-rank
dry run.

Counterpart of the JAX package's root ``__graft_entry__.py``. `entry`
returns the flagship forward step (the all-mode FD waveform of the rwz
physics on the downsampled 1-yr grid) and its example arguments, on the
card. `dryrun_multichip` spawns ``n_devices`` ranks (`parallel.mesh`) and
takes, on a tiny likelihood, one walker-sharded stretch-move step and then a
10-step chain on a composed (n/2 walkers x 2 frequency) mesh, which must
equal its single-process replay, run in the spawning process while the
ranks work: equal accept counts, coordinates within 1e-12; it prints
whether the match is bit-exact.

The ensemble is replicated: every rank holds every walker and draws the
same stretch draws from an identically seeded ``torch.Generator``; only the
likelihood rows are sharded. The walker-and-frequency likelihood sums each
walker's bins shard-hierarchically: the inner sum per frequency shard, the
shards' partial sums added in rank order; the replay cuts the bins the same
way (`parallel.mesh.frequency_bounds`).

    python -m emri_frequencydomainwaveforms_tpu_torch.graft_entry [n_ranks] [--cpu]
        [--backend gloo|nccl]

runs the dry run (default 4 ranks, on the card: every rank on
``cuda:(rank % device_count)``, exchanging through gloo).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the dry run's tiny model: short trajectory, few modes, a small uniform grid
_F0, _DF, _NF = 1e-3, 3e-7, 256
_BETAS = (1.0, 0.5)
_CHAIN_STEPS = 10


def entry(device=None):
    """(forward, example_args): the flagship forward step on ``device``
    (default the current CUDA device).

    ``forward(params)`` maps (M, mu, p0, e0, theta, phi) to the four
    (1, nf) float64 spectra (h+ re, im, hx re, im) of the all-mode FD
    waveform: rwz physics (the multipole flux grid, tail, factorized and
    rwz amplitudes), `default_mode_table(30)`, 1 yr at dt = 10 s with the
    positive grid downsampled by 100, ``k_max=48``, ``band_runs=2048``.
    """
    from .models.amplitude import default_mode_table
    from .models.waveform import default_frequencies, fd_waveform_core, waveform_prologue
    from .utils.device import resolve_device

    dev = resolve_device(device)
    table = default_mode_table(30)
    t_years = 1.0
    freq = default_frequencies(t_years, 10.0)
    f_np = freq[freq > 0][::100]
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    def forward(params):
        m, mu, p0, e0, theta, phi = params
        pro = waveform_prologue(
            m, mu, p0, e0, theta, phi, 1.0, 0.0, 0.0,
            t_years=t_years, table=table, k_max=48, eps=1e-2,
            flux="multipole_rwz", tail=True, factorized=True, rwz=True, device=dev,
        )
        return fd_waveform_core(pro, table, len(f_np), channels=True, uniform=uniform,
                                band_runs=2048)

    example_args = (torch.tensor([1e6, 10.0, 12.0, 0.35, 0.7, 0.5], dtype=torch.float64,
                                 device=dev),)
    return forward, example_args


def _power(x: torch.Tensor, device, bins=None) -> torch.Tensor:
    """(n, 6) parameters -> (n, bins) |h+|^2 per bin of the tiny waveform on
    ``device`` (p0 = 10 + x[:, 2]; ``bins=(lo, hi)`` a frequency shard)."""
    from .models.amplitude import default_mode_table
    from .models.waveform import fd_waveform_core, waveform_prologue

    table = default_mode_table(4)
    p0 = 10.0 + x[:, 2].to(device)
    pro = waveform_prologue(
        1e6, 10.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=0.005, table=table, k_max=8, eps=1e-2, max_steps=64, device=device,
    )
    hpr, hpi, _, _ = fd_waveform_core(pro, table, _NF, channels=True, uniform=(_F0, _DF),
                                      bin_range=bins)
    return hpr * hpr + hpi * hpi


def _ll_of(bin_sums: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """log L of rows ``x`` from their summed power: -(power 1e34 + |x|^2) / 2."""
    from .ops.row_ops import row_sum

    return -0.5 * (bin_sums.cpu() * 1e34 + row_sum(x * x))


def _logp(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x.abs() < 10.0).all(dim=-1), 0.0, -torch.inf).to(torch.float64)


def _walker_ll(mesh, device):
    """The walker-sharded log L: each rank's rows, gathered in rank order."""
    from .ops.row_ops import row_sum
    from .parallel.mesh import walker_sharded

    return lambda x: walker_sharded(lambda rows: _ll_of(row_sum(_power(rows, device)), rows),
                                    x, mesh)


def _composed_ll(mesh2, device):
    """The walker x frequency log L on ``mesh2``: rows over "walkers", bins
    over "freq"; per row the inner sum over the rank's bins, the shards'
    partial sums gathered and added in rank order."""
    from .models.waveform import uniform_bins_per_run
    from .ops.row_ops import row_sum
    from .parallel.mesh import frequency_range, gather_shards, ordered_sum, shard_range

    n_f = mesh2.size(1)

    def logl(x):
        lo, hi = shard_range(x.shape[0], mesh2, "walkers")
        bins = frequency_range(_NF, uniform_bins_per_run(_NF), mesh2, "freq")
        part = (row_sum(_power(x[lo:hi], device, bins)).cpu() if hi > lo
                else torch.empty(0, dtype=torch.float64))
        parts = gather_shards(part[:, None], mesh2, "freq", 1, n_f)
        return gather_shards(_ll_of(ordered_sum(parts), x[lo:hi]), mesh2, "walkers", 0,
                             x.shape[0])

    return logl


def _replay_ll(n_f, device):
    """The composed log L replayed in one process: every row and bin here,
    the bins cut into the same frequency shards and summed the same way."""
    from .models.waveform import uniform_bins_per_run
    from .ops.row_ops import row_sum
    from .parallel.mesh import frequency_bounds, ordered_sum

    bounds = frequency_bounds(_NF, uniform_bins_per_run(_NF), n_f)

    def logl(x):
        power = _power(x, device)
        parts = torch.stack([row_sum(power[:, lo:hi].contiguous()) for lo, hi in bounds], -1)
        return _ll_of(ordered_sum(parts), x)

    return logl


def _chain(coords0, logl, seed):
    """``_CHAIN_STEPS`` stretch-move steps from ``coords0`` (ntemps,
    nwalkers, ndim), the draws from one generator seeded ``seed``: (coords,
    log L, accepted per step and temperature)."""
    from .inference.moves.stretch import StretchMove

    move, betas = StretchMove(), torch.tensor(_BETAS, dtype=torch.float64)
    shape = tuple(coords0.shape)
    coords = coords0
    ll = logl(coords.reshape(-1, shape[-1])).reshape(shape[:2])
    lp = _logp(coords.reshape(-1, shape[-1])).reshape(shape[:2])
    gen = torch.Generator().manual_seed(seed)
    acc = []
    for _ in range(_CHAIN_STEPS):
        coords, ll, lp, n_acc = move.propose(gen, coords, ll, lp, betas, _logp, logl)
        acc.append(n_acc)
    return coords, ll, torch.stack(acc)


def _dry_inputs(n_devices: int):
    """The step's ensemble and the chain's start, (ntemps, 4 n, 6) each, from
    ``numpy.random.default_rng(0)`` in that order."""
    rng = np.random.default_rng(0)
    shape = (len(_BETAS), 4 * n_devices, 6)
    return torch.as_tensor(rng.normal(0, 0.1, shape)), torch.as_tensor(rng.normal(0, 0.1, shape))


def dryrun_rank(n_devices: int, device=None) -> dict:
    """One rank's part of `dryrun_multichip` (the process group is up).

    Returns, on every rank, the walker-sharded step's accepts per
    temperature and coordinates, and, for an even ``n_devices``, the
    composed chain's accepts and coordinates.
    """
    from .inference.moves.stretch import StretchMove
    from .ops import fd_dense
    from .parallel.mesh import composed_mesh, rank_device, walker_mesh

    dev = rank_device(device)
    fd_dense.fd_dense_accumulate.launches = 0
    mesh = walker_mesh(n_devices)
    ntemps, nwalkers, ndim = len(_BETAS), 4 * n_devices, 6
    coords, coords0 = _dry_inputs(n_devices)
    logl = _walker_ll(mesh, dev)
    ll = logl(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
    lp = _logp(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
    betas = torch.tensor(_BETAS, dtype=torch.float64)
    new, _, _, n_acc = StretchMove().propose(torch.Generator().manual_seed(0), coords, ll, lp,
                                             betas, _logp, logl)
    out = {"device": str(dev), "step_coords": new, "step_accepted": n_acc}
    if n_devices % 2 == 0:
        n_w, n_f = n_devices // 2, 2
        mesh2 = composed_mesh(n_w, n_f)
        c_sh, ll_sh, acc_sh = _chain(coords0, _composed_ll(mesh2, dev), 42)
        out.update(mesh=(n_w, n_f), chain_coords=c_sh, chain_ll=ll_sh, chain_accepted=acc_sh)
    out["fd_dense_launches"] = fd_dense.fd_dense_accumulate.launches
    return out


def dryrun_replay(n_devices: int, device=None) -> dict:
    """The composed chain of `dryrun_rank` replayed in this one process on
    ``device`` (default the current CUDA device): every row and bin here, the
    bins cut into the same 2 frequency shards and summed the same way."""
    from .utils.device import resolve_device

    c_1, ll_1, acc_1 = _chain(_dry_inputs(n_devices)[1], _replay_ll(2, resolve_device(device)),
                              42)
    return dict(replay_coords=c_1, replay_ll=ll_1, replay_accepted=acc_1)


def check_dryrun(out: dict, n_devices: int) -> dict:
    """Check and print a `dryrun_rank` result (rank 0's, with the
    `dryrun_replay` keys added): the walker-sharded step finite and of its
    shape; the composed chain's accepts equal to its replay's and its
    coordinates within 1e-12. Adds ``exact``: whether the chain matched its
    replay bit for bit (coordinates and log L)."""
    new = out["step_coords"]
    if tuple(new.shape) != (len(_BETAS), 4 * n_devices, 6) or not bool(torch.isfinite(new).all()):
        raise RuntimeError(f"dryrun_multichip: walker-sharded step gave {tuple(new.shape)}, "
                           f"finite {bool(torch.isfinite(new).all())}")
    print(f"dryrun_multichip OK: {n_devices} ranks, walker-sharded step executed on "
          f"{out['device']} (rank 0); accepted per temp: {out['step_accepted'].tolist()}",
          flush=True)
    if "chain_coords" in out:
        c_sh, c_1 = out["chain_coords"], out["replay_coords"]
        if not torch.equal(out["chain_accepted"], out["replay_accepted"]):
            raise RuntimeError(f"dryrun_multichip: composed chain accepts "
                               f"{out['chain_accepted'].tolist()} != replay "
                               f"{out['replay_accepted'].tolist()}")
        if not bool(torch.isfinite(c_sh).all()):
            raise RuntimeError("dryrun_multichip: composed chain coordinates not finite")
        np.testing.assert_allclose(c_sh.numpy(), c_1.numpy(), rtol=1e-12, atol=1e-12)
        out["exact"] = bool(torch.equal(c_sh, c_1) and torch.equal(out["chain_ll"],
                                                                  out["replay_ll"]))
        n_w, n_f = out["mesh"]
        print(f"dryrun_multichip composed OK: {_CHAIN_STEPS}-step chain on ({n_w} walkers x "
              f"{n_f} freq) mesh matches single-process replay "
              f"({'bit-exact' if out['exact'] else 'to <=1e-12'}); "
              f"total accepted: {int(out['chain_accepted'].sum())}", flush=True)
    return out


def dryrun_multichip(n_devices: int, device=None, backend: str = "gloo") -> dict:
    """Spawn ``n_devices`` ranks and run `dryrun_rank` on them, replay the
    composed chain here meanwhile (`dryrun_replay`), and `check_dryrun` the
    result (rank 0's with the replay's, returned).

    ``device``: where every rank and the replay compute (default: each rank
    ``cuda:(rank % device_count)``, the replay the current CUDA device);
    ``backend``: the process group's ("gloo", or "nccl" with one GPU per
    rank). The CUDA kernels are built here, once, before the ranks start, so
    that the ranks do not race on the build directory.
    """
    from .ops import cuda_build
    from .parallel.mesh import start_ranks

    if device is None or torch.device(device).type == "cuda":
        cuda_build.build_all()
    ranks = start_ranks(dryrun_rank, n_devices, (n_devices, device), backend=backend)
    replay = dryrun_replay(n_devices, device) if n_devices % 2 == 0 else {}
    out = ranks.join()
    out.update(replay)
    return check_dryrun(out, n_devices)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Multi-rank dry run of the port's sampler "
                                                 "step and composed walker x frequency chain.")
    parser.add_argument("n_ranks", nargs="?", type=int, default=4)
    parser.add_argument("--cpu", action="store_true", help="compute every rank on the CPU")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_ranks, device="cpu" if args.cpu else None, backend=args.backend)


if __name__ == "__main__":
    main()
