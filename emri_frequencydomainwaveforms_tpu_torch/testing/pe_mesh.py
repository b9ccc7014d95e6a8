"""The PE likelihood of ``cli/emri_pe.py`` on fixed walkers, evaluated by
walker shards and by walker x frequency shards (``chip_smoke.py``'s
``[mesh]`` phase, ``testing/batch_dependence.py`` and the CPU tests).

`pe_problem` builds the injection once (no duration solve: p0 is given) and
16 walkers around it; `pe_likelihood` rebuilds the template and the
whitened likelihood from it on any device, with a template that keeps its
last batch's live knots and spectra; `mesh_rank` is one rank's part of the
sharded evaluations, followed by the multi-rank dry run
(`graft_entry.dryrun_rank`), all in one process group.
"""

from __future__ import annotations

import numpy as np
import torch

N_WALKERS = 16


def pe_problem(argv: str, p0: float, device, flux_grid=None, n_walkers: int = N_WALKERS) -> dict:
    """The PE configuration ``argv`` (`emri_pe.build_parser` flags) at the
    given p0: the frozen slot table of the injection, the grid, the truth,
    the injected channels (the FD template at the truth, complex numpy) and
    ``n_walkers`` walkers within ~1e-7 of the truth (numpy seed 1)."""
    from ..cli import emri_pe
    from ..models.amplitude import default_mode_table
    from ..models.waveform import default_frequencies, waveform_prologue

    args = emri_pe.build_parser().parse_args(argv.split())
    table = default_mode_table(30)
    f_np = default_frequencies(args.Tobs, args.dt)
    f_np = f_np[f_np > 0][::args.downsample]
    pro = waveform_prologue(
        args.M, args.mu, p0, args.e0, np.pi / 4, np.pi / 3, 1.0, 1.0, 2.0, t_years=args.Tobs,
        table=table, k_max=args.kmax, eps=args.eps, max_steps=args.max_steps,
        flux_grid=flux_grid, device=device, **emri_pe.physics(args))
    spec = dict(argv=argv, p0=p0, table=table.take(pro.sel.idx[0].cpu().numpy()), f=f_np)
    truth = np.array([np.log(args.M), np.log(args.mu / args.M), p0, args.e0, 1.0, 2.0])
    like, _ = pe_likelihood(spec, device, flux_grid, inject=False)
    inj = like.template_model(like.transform.both_transforms(torch.as_tensor(truth)[None]))
    spec["data"] = [(re[0].double() + 1j * im[0].double()).cpu().numpy() for re, im in inj]
    spec["truth"] = truth
    spec["x"] = truth + np.random.default_rng(1).normal(0, 1, (n_walkers, 6)) * (
        np.abs(truth) * 1e-7 + 1e-9)
    return spec


def pe_likelihood(spec: dict, device, flux_grid=None, inject: bool = True):
    """(the `Likelihood` of ``spec`` on ``device``, the dict its template
    fills with the last batch's ``n_live`` (m,) and ``template`` (m, 4,
    bins) float32, both on the CPU). The template is `emri_pe.fd_template`
    (``bins=`` a frequency shard); with ``inject`` the likelihood holds
    ``spec["data"]`` under the PE run's noise."""
    from ..cli import emri_pe
    from ..lisa.likelihood import Likelihood
    from ..lisa.sensitivity import get_sensitivity

    args = emri_pe.build_parser().parse_args(spec["argv"].split())
    table_t, f_np = spec["table"], spec["f"]
    last = {}
    template = emri_pe.fd_template(args, table_t, np.arange(table_t.num_modes), f_np,
                                   flux_grid=flux_grid, device=device, record=last)
    like = Likelihood(template, 2, f_arr=f_np, parameter_transforms=emri_pe.parameter_transform(),
                      device=device)
    if inject:
        like.inject_signal(spec["data"], noise_fn=lambda f: np.asarray(
            get_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd")))
    return like, last


def mesh_rank(spec: dict, flux_grid=None, device=None) -> dict:
    """One rank's part of the sharded PE evaluations (the process group is
    up, 4 ranks for the 2 x 2 mesh): the walkers of ``spec`` by walker
    shards on `walker_mesh`, then by walker x frequency shards on a
    (ranks / 2) x 2 `composed_mesh` (each rank's template on its bin range
    only; per walker the residual power summed per shard, the shards'
    partial sums added in rank order). Then `graft_entry.dryrun_rank`.

    Returns, on every rank, each evaluation's gathered log L, live knots and
    templates, every rank's fd_dense launches in the walker-sharded
    evaluation, the dry run's result and this rank's host seconds per part.
    """
    import time

    import torch.distributed as dist

    from ..graft_entry import dryrun_rank
    from ..models.waveform import uniform_bins_per_run
    from ..ops import fd_dense
    from ..parallel.mesh import (composed_mesh, frequency_range, gather_frequency,
                                 gather_shards, ordered_sum, rank_device, shard_range,
                                 walker_mesh)

    t0 = time.perf_counter()
    dev = rank_device(device)
    grid = None if flux_grid is None else flux_grid._replace(values=flux_grid.values.to(dev))
    like, last = pe_likelihood(spec, dev, grid)
    seconds = {"set-up": time.perf_counter() - t0}
    x = torch.as_tensor(spec["x"])
    n, nf = x.shape[0], len(spec["f"])
    world = dist.get_world_size()
    fd_dense.fd_dense_accumulate.launches = 0
    mesh = walker_mesh(world)
    lo, hi = shard_range(n, mesh, "walkers")
    ll = like(x[lo:hi]).cpu()
    launches = torch.tensor([fd_dense.fd_dense_accumulate.launches])
    seconds["walker shards"] = time.perf_counter() - t0 - sum(seconds.values())
    walker = dict(ll=gather_shards(ll, mesh, "walkers", 0, n),
                  n_live=gather_shards(last["n_live"], mesh, "walkers", 0, n),
                  template=gather_shards(last["template"], mesh, "walkers", 0, n))

    mesh2 = composed_mesh(world // 2, 2)
    wlo, whi = shard_range(n, mesh2, "walkers")
    r = uniform_bins_per_run(nf)
    bins = frequency_range(nf, r, mesh2, "freq")
    part = like.residual_power(x[wlo:whi], bins=bins).cpu()
    parts = gather_shards(part[:, None], mesh2, "freq", 1, 2)
    spectra = gather_frequency(last["template"], mesh2, "freq", 2, nf, r)
    composed = dict(ll=gather_shards(-2.0 * ordered_sum(parts), mesh2, "walkers", 0, n),
                    n_live=gather_shards(last["n_live"], mesh2, "walkers", 0, n),
                    template=gather_shards(spectra, mesh2, "walkers", 0, n), bins=bins)
    seconds["walker x frequency shards"] = time.perf_counter() - t0 - sum(seconds.values())
    dry = dryrun_rank(world, device)
    seconds["dry run"] = time.perf_counter() - t0 - sum(seconds.values())
    return dict(device=str(dev), walker=walker, composed=composed,
                launches=gather_shards(launches, mesh, "walkers", 0, world), dryrun=dry,
                seconds=seconds)


__all__ = ["pe_problem", "pe_likelihood", "mesh_rank", "N_WALKERS"]
