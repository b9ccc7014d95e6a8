"""Whether a PE walker's result depends on the batch it is evaluated in.

Builds the PE template of ``cli/emri_pe.py`` at the production settings
(1 yr, rwz physics, 15,780 bins, 48 frozen slots; p0 fixed at the value the
duration solve gives, so no solve runs) and 16 walkers around the injection.
Each stage of the template then runs on fixed inputs (the batch of 16's own
inputs to that stage) for walkers 0 and 5 alone and in batches of 2, 4, 8
and 16 (the walker first, the others after), and its row is held to the
walker's row of the batch of 16:

- one RHS evaluation of the trajectory (the fundamental frequencies, the
  flux interpolation, the whole RHS and its forward-mode tangent, which
  pads the knots), bit for bit: the adaptive dp5 controller turns a last-bit
  difference into another step sequence;
- the dp5 trajectory (live knots, times, phases), bit for bit;
- the amplitudes, the Ylm, the splines, the level-1 tables, the dense-pass
  kernel's output (at the main path's run size; the batch of 16's replay
  must equal the main path's own output and fill its slots' bands)
  and the likelihood's sum over bins, to 1e-12 relative;
- the whole template and log L, to 1e-12 relative with equal knot counts.

It also probes the raw PyTorch reductions and products the path once used
(informational: these are what depend on the batch) beside what it uses now
(gated, bit for bit): the fixed-order `ops.row_sum` and `ops.row_cumsum`,
and cuBLAS's batched products for the amplitudes' antiderivative (one
product per row) and projection (`models/amplitude.py::_products`).
Each line says whether the match is bit-exact. Exits 1 if any gated stage
differs past its bound.

    python -m emri_frequencydomainwaveforms_tpu_torch.testing.batch_dependence [cpu] [launches]

Runs on the current CUDA device, or on the CPU with ``cpu`` (at 0.05 yr and
the Peters-Mathews flux there, where the trajectories are cheap). On the
card it first counts the kernels one RHS evaluation of the batch of 16
launches (``torch.profiler``); ``launches`` stops after that count.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .pe_mesh import N_WALKERS

P0 = 9.528028  # the PE run's duration solve at 1 yr (chip_smoke.py [pe])
PE_ARGS = ("-Tobs 1 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
           "-injectFD 1 -flux multipole_rwz -amp rwz -kmax 48 -nwalkers 32 -ntemps 4")
CPU_ARGS = ("-Tobs 0.05 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
            "-injectFD 1 -flux pm -amp flat -kmax 16")
BATCHES = (1, 2, 4, 8, 16)
WALKERS = (0, 5)
DOWNSTREAM_TOL = 1e-12  # relative, each row against the batch of 16
DENSE_FILLED = 0.99  # share of its bands' bins the dense pass fills, per walker


def _rel(a, b) -> float:
    """max |a - b| / max |b| in float64 (0 for two empty or equal tensors)."""
    a, b = a.double(), b.double()
    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    fin = torch.isfinite(b)
    if not bool((torch.isfinite(a) == fin).all()):
        return float("inf")
    d = torch.where(fin, a - b, torch.zeros_like(b)).abs().max()
    return float(d / (torch.where(fin, b, torch.zeros_like(b)).abs().max() + 1e-300))


def _flat(x) -> list[torch.Tensor]:
    """The tensors of a (nested) tuple / NamedTuple / list, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b) or (
        a.is_floating_point() and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))))


def take_rows(x, rows):
    """Rows ``rows`` of every tensor of a (nested) tuple / NamedTuple."""
    if isinstance(x, torch.Tensor):
        return x[rows]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(take_rows(v, rows) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(take_rows(v, rows) for v in x)
    return x


def batch_rows(k: int, b: int, n: int = N_WALKERS) -> list[int]:
    """Walker ``k`` first, then the first ``b - 1`` others."""
    return [k] + [j for j in range(n) if j != k][: b - 1]


def band_cover(groups, r: int, nf: int) -> torch.Tensor:
    """(B, nf) bool: the bins that some live slot's kept band covers."""
    n_b, dev = groups[0].pc.shape[0], groups[0].pc.device
    edges = torch.zeros((n_b, nf + 1), dtype=torch.int64, device=dev)
    for grp in groups:
        live = grp.i_lo != torch.iinfo(torch.int32).max
        start = grp.g0.long() * r
        lo = (start + grp.i_lo.long()).clamp(0, nf)
        hi = (start + grp.i_hi.long() + 1).clamp(0, nf)
        one = (live & (hi > lo)).long()
        edges.scatter_add_(1, lo, one)
        edges.scatter_add_(1, hi, -one)
    return torch.cumsum(edges, dim=-1)[:, :nf] > 0


def compare_stage(name: str, fn, bound: float, sync, gated: bool = True,
                  batches=BATCHES, walkers=WALKERS) -> bool:
    """Run ``fn(rows)`` (-> tensors with a leading row axis) on the batch of
    16 and on each walker's smaller batches; print the worst difference of
    the walker's row and whether every match is bit-exact. Returns whether
    the stage kept its bound (always True when not ``gated``)."""
    full = _flat(fn(list(range(N_WALKERS))))
    sync()
    worst, exact, per = 0.0, True, []
    for k in walkers:
        for b in batches:
            out = _flat(fn(batch_rows(k, b)))
            sync()
            d = max(_rel(o[0], f[k]) for o, f in zip(out, full))
            e = all(_equal(o[0], f[k]) for o, f in zip(out, full))
            worst, exact = max(worst, d), exact and e
            per.append(f"{k}@{b} {d:.3e}")
    ok = worst <= bound
    tag = "" if gated else " (informational)"
    print(f"[batch] {name}{tag}: worst {worst:.3e} "
          f"({'bit-exact' if exact else 'not bit-exact'}; bound {bound:g}) "
          f"[{', '.join(per)}]", flush=True)
    return ok or not gated


def op_probes(dev, sync, k_knots: int, nf: int, n_slots: int) -> bool:
    """The raw reductions and products of the path at its shapes, on seeded
    inputs (one block of rows per walker), beside the formulations the port
    uses. Returns whether the port's were bit-exact."""
    from ..models.amplitude import _products
    from ..ops.row_ops import row_cumsum, row_sum

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float64):
        return torch.rand(shape, generator=g, dtype=torch.float64).to(dtype).to(dev)

    x256 = rnd(N_WALKERS, 256)
    x4 = rnd(N_WALKERS, 4)
    xnf = rnd(N_WALKERS, nf)
    xk = rnd(N_WALKERS, k_knots, 256, dtype=torch.float32)
    xs = rnd(N_WALKERS, n_slots, nf)
    a_op = rnd(256, 256, dtype=torch.float32)
    n_rows, n_cols = 14, 62
    integ = rnd(N_WALKERS, k_knots, n_rows, 256, dtype=torch.float32)
    cs = rnd(N_WALKERS, k_knots, 256, n_cols, dtype=torch.float32)
    raw = [
        ("torch.sum over 256 nodes, float64 (B, 256): fundamental_frequencies",
         lambda r: torch.sum(x256[r], dim=-1)),
        ("torch.mean over 4 components, float64 (B, 4): the dp5 error norm",
         lambda r: torch.mean(x4[r], dim=-1)),
        (f"torch.sum over {nf} bins, float64 (B, nf): the likelihood",
         lambda r: torch.sum(xnf[r], dim=-1)),
        (f"torch.cumsum over {nf} nodes, float64 (B x {n_slots}, nf): the level-1 envelope "
         f"phase", lambda r: torch.cumsum(xs[r], dim=-1)),
        (f"torch.sum over 256 nodes, float32 (B x {k_knots}, 256): the amplitudes",
         lambda r: torch.sum(xk[r].reshape(-1, 256), dim=-1)),
        (f"matmul float32 (B x {k_knots}, 256) @ (256, 256): the amplitudes' antiderivative",
         lambda r: (xk[r].reshape(-1, 256) @ a_op)),
        (f"bmm float32 (B, {k_knots}, 256) @ (256, 256) expanded to (B, 256, 256): one "
         f"product per walker",
         lambda r: torch.bmm(xk[r], a_op.expand(len(r), 256, 256))),
    ]
    for name, fn in raw:
        compare_stage(name, lambda r, fn=fn: fn(r).reshape(len(r), -1), 0.0, sync, gated=False)
    ported = [
        ("row_sum over 256 nodes, float64", lambda r: row_sum(x256[r])),
        (f"row_sum over {nf} bins, float64", lambda r: row_sum(xnf[r])),
        ("row_sum over 256 nodes, float32", lambda r: row_sum(xk[r].reshape(-1, 256))),
        (f"row_cumsum over {nf} nodes, float64", lambda r: row_cumsum(xs[r])),
        (f"_products float32 (B x {k_knots}, 1, 256) @ (256, 256), one product per row: "
         f"the amplitudes' antiderivative",
         lambda r: _products(xk[r].reshape(-1, 1, 256), a_op)),
        (f"_products float32 (B x {k_knots}, {n_rows}, 256) @ (B x {k_knots}, 256, {n_cols}): "
         f"the amplitudes' projection",
         lambda r: _products(integ[r].reshape(-1, n_rows, 256), cs[r].reshape(-1, 256, n_cols))),
    ]
    return all([compare_stage(name, lambda r, fn=fn: fn(r).reshape(len(r), -1), 0.0, sync)
                for name, fn in ported])


def main(argv=None) -> int:
    from ..cli import emri_pe
    from ..models.amplitude import family_constants, mode_amplitudes
    from ..models.flux import as_flux_fn, inspiral_rhs, pn_flux_e_l
    from ..models.geodesic import fundamental_frequencies
    from ..models.inspiral import flux_model, schwarz_ecc_flux_inspiral
    from ..models.rwz_calibration import rwz_rows
    from ..models import summation_fd
    from ..models.summation_fd import prepare_fd_inputs
    from ..models.waveform import _sigma, fd_waveform_core
    from ..ops import fd_dense
    from ..utils.ylm import spin_weighted_ylm
    from .pe_mesh import pe_likelihood, pe_problem

    argv = sys.argv[1:] if argv is None else argv
    on_cpu = "cpu" in argv
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    args = emri_pe.build_parser().parse_args((CPU_ARGS if on_cpu else PE_ARGS).split())
    p0 = 8.5 if on_cpu else P0
    if not on_cpu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(f"[batch] {card} | torch {torch.__version__}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    phys = emri_pe.physics(args)
    grid = None if args.flux == "pm" else flux_model(args.flux, dev)
    flux_fn = as_flux_fn(pn_flux_e_l if grid is None else grid)
    if dev.type == "cuda":
        # what one RHS evaluation of a batch of 16 states issues to the card
        y = torch.stack([p0 + torch.linspace(0.0, 0.1, N_WALKERS, dtype=torch.float64),
                         torch.full((N_WALKERS,), args.e0, dtype=torch.float64),
                         torch.zeros(N_WALKERS, dtype=torch.float64),
                         torch.zeros(N_WALKERS, dtype=torch.float64)], dim=-1).to(dev)
        act = torch.profiler.ProfilerActivity
        inspiral_rhs(y, args.mu / args.M, flux_fn)
        sync()
        with torch.profiler.profile(activities=[act.CUDA]) as prof:
            inspiral_rhs(y, args.mu / args.M, flux_fn)
            sync()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]
        print(f"[batch] one RHS evaluation (B = {N_WALKERS}): {len(names)} launches on the card, "
              f"{sum('row_sum' in k for k in names)} of them row_sum, "
              f"{sum('reduce_kernel' in k for k in names)} PyTorch reductions, "
              f"{sum(k.startswith(('Memcpy', 'Memset')) for k in names)} copies and fills",
              flush=True)
        if "launches" in argv:
            return 0
    spec = pe_problem((CPU_ARGS if on_cpu else PE_ARGS), p0, dev, grid)
    table_t, f_np = spec["table"], spec["f"]
    prologue = emri_pe.template_prologue(args, table_t, np.arange(table_t.num_modes),
                                         flux_grid=grid, device=dev)
    like, _ = pe_likelihood(spec, dev, grid)
    template = like.template_model
    x = torch.as_tensor(spec["x"])
    p14 = like.transform.both_transforms(x).to(dev)
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    # the batch of 16's inputs to each stage
    pro16 = prologue(p14)
    sync()
    m, mu, e0 = p14[:, 0], p14[:, 1], p14[:, 4]
    nu = mu / m
    knot = 7  # a live knot of every walker
    traj16 = schwarz_ecc_flux_inspiral(m, mu, p14[:, 3], e0, t_years=args.Tobs,
                                       max_steps=args.max_steps, flux=args.flux, flux_grid=grid)
    y16 = torch.stack([traj16.p[:, knot], traj16.e[:, knot], traj16.Phi_phi[:, knot],
                       traj16.Phi_r[:, knot]], dim=-1)
    family_c = torch.as_tensor(family_constants(table_t), device=dev)
    rows_rwz = rwz_rows(table_t.ls, table_t.ms, table_t.ns, dev) if phys["rwz"] else None
    print(f"[batch] {args.Tobs} yr, flux {args.flux}, amp {args.amp}, {len(f_np)} bins, "
          f"{table_t.num_modes} slots, {N_WALKERS} walkers; live knots in the batch of 16: "
          f"{pro16.n_live.tolist()}", flush=True)

    def rhs(y, r):
        return inspiral_rhs(y, nu[r], flux_fn)

    captured = []

    def capture(groups, *, r, nf):
        out = fd_dense.fd_dense_accumulate(groups, r=r, nf=nf)
        captured.append((groups, r, out))
        return out

    def level1(r):
        captured.clear()
        saved = summation_fd.fd_dense_accumulate
        summation_fd.fd_dense_accumulate = capture
        try:
            fd_waveform_core(take_rows(pro16, r), table_t, len(f_np), channels=True,
                             uniform=uniform, out_f32=True)
        finally:
            summation_fd.fd_dense_accumulate = saved
        return captured[0][0]

    groups16 = level1(list(range(N_WALKERS)))
    # the dense pass replays the batch of 16's tables at the run size the
    # main path used; its replay must equal the main path's own output
    _, r16, dense16 = captured[0]
    replay16 = fd_dense.fd_dense_accumulate(groups16, r=r16, nf=len(f_np))
    cover = band_cover(groups16, r16, len(f_np))
    nonzero = (dense16 != 0).any(dim=1)
    filled = float(((nonzero & cover).sum(-1) / cover.sum(-1).clamp_min(1)).min())
    dense_ok = _equal(replay16, dense16) and bool(cover.any(-1).all()) and filled >= DENSE_FILLED
    print(f"[batch] dense pass of the batch of 16 at r = {r16} (the main path's run size): "
          f"replay {'equals' if _equal(replay16, dense16) else 'DIFFERS FROM'} the main path's "
          f"output; the slots' bands cover {float(cover.double().mean(-1).min()):.4f} of the "
          f"bins and the output fills {filled:.6f} of them (least walker; >= {DENSE_FILLED})",
          flush=True)
    tmpl16 = [(re.double(), im.double()) for re, im in template(p14)]

    def splines(r):
        pro = take_rows(pro16, r)
        sig = _sigma(table_t, dev)
        (ypr, ypi), (ymr, ymi) = pro.y_plus, pro.y_minus
        w1 = (sig * ymr + ypr, sig * ymi - ypi)
        w2 = (-(sig * ymi + ypi), sig * ymr - ypr)
        return prepare_fd_inputs(pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re,
                                 pro.a_im, table_t, pro.sel, w1, w2, w1n=w1, w2n=w2)

    def ll_sum(r):
        saved = like.template_model
        like.template_model = lambda full: [(re[r], im[r]) for re, im in tmpl16]
        try:
            return like(x[r])
        finally:
            like.template_model = saved

    def e2e(r):
        pro = prologue(p14[r])
        out = template(p14[r])
        return pro.n_live.double(), [o for pair in out for o in pair], like(x[r])

    stages = [
        ("rhs: fundamental_frequencies",
         lambda r: fundamental_frequencies(y16[r, 0], y16[r, 1].clamp_min(1e-9)), 0.0),
        ("rhs: flux", lambda r: flux_fn(y16[r, 0], y16[r, 1].clamp_min(1e-9)), 0.0),
        ("rhs: one evaluation", lambda r: rhs(y16[r], r), 0.0),
        ("rhs: forward-mode tangent (the knots' pad)",
         lambda r: torch.func.jvp(lambda y: rhs(y, r), (y16[r],), (rhs(y16[r], r),)), 0.0),
        ("trajectory (dp5): knots, times, p, e, phases",
         lambda r: (lambda t: (t.n.double(), t.t, t.p, t.e, t.Phi_phi, t.Phi_r))(
             schwarz_ecc_flux_inspiral(m[r], mu[r], p14[r, 3], e0[r], t_years=args.Tobs,
                                       max_steps=args.max_steps, flux=args.flux,
                                       flux_grid=grid)), 0.0),
        ("amplitudes",
         lambda r: mode_amplitudes(traj16.p[r], traj16.e[r], table_t, tail=phys["tail"],
                                   factorized=phys["factorized"], rwz=phys["rwz"],
                                   family_c=family_c, rwz_rows=rows_rwz), DOWNSTREAM_TOL),
        ("ylm", lambda r: (spin_weighted_ylm(table_t.ls, table_t.ms, p14[r, 7], p14[r, 8]),
                           spin_weighted_ylm(table_t.ls, -table_t.ms, p14[r, 7], p14[r, 8])),
         DOWNSTREAM_TOL),
        ("splines (prepare_fd_inputs)", splines, DOWNSTREAM_TOL),
        ("level-1 tables", level1, DOWNSTREAM_TOL),
        ("dense-pass kernel output",
         lambda r: fd_dense.fd_dense_accumulate(take_rows(groups16, r), r=r16, nf=len(f_np)),
         DOWNSTREAM_TOL),
        ("likelihood sum over bins", ll_sum, DOWNSTREAM_TOL),
        ("whole: knots, template, log L", e2e, DOWNSTREAM_TOL),
    ]
    # the probes' amplitude blocks at the PE's knot count (fewer on the CPU)
    ok = op_probes(dev, sync, 32 if on_cpu else args.max_steps, len(f_np), table_t.num_modes)
    ok = dense_ok and ok
    for name, fn, tol in stages:
        ok = compare_stage(name, fn, tol, sync) and ok
    print(f"[batch] {'every gated stage kept its bound' if ok else 'FAILED: a gated stage differs'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
