"""Whether a PE template row depends on the batch it is evaluated in.

Builds the PE template of ``cli/emri_pe.py`` at the production settings
(1 yr, rwz physics, 15,780 bins, 48 frozen slots; p0 fixed at the value the
duration solve gives, so no solve runs) and evaluates 16 walkers around the
injection in one batch, then walkers 0 and 5 alone and in batches of 2, 4
and 8 (themselves first, the other walkers after). For each it prints the
live knots in both batches and the largest difference, relative to the
batch-of-16 values, of the knot times, the phase, the amplitudes, the Ylm
and the template.

    python -m emri_frequencydomainwaveforms_tpu_torch.testing.batch_dependence [cpu]

Runs on the current CUDA device, or on the CPU with ``cpu`` (at 0.05 yr and
the Peters-Mathews flux there, where the trajectories are cheap).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

P0 = 9.528028  # the PE run's duration solve at 1 yr (chip_smoke.py [pe])
PE_ARGS = ("-Tobs 1 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
           "-injectFD 1 -flux multipole_rwz -amp rwz -kmax 48 -nwalkers 32 -ntemps 4")
CPU_ARGS = ("-Tobs 0.05 -M 1e6 -mu 10 -e0 0.35 -dt 10 -eps 1e-2 -downsample 100 -template fd "
            "-injectFD 1 -flux pm -amp flat -kmax 16")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-300))


def main(argv=None) -> None:
    from ..cli import emri_pe
    from ..models.amplitude import default_mode_table
    from ..models.inspiral import flux_model
    from ..models.waveform import default_frequencies, fd_waveform_core, waveform_prologue
    from ..utils.transform import TransformContainer

    on_cpu = "cpu" in (argv if argv is not None else sys.argv[1:])
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
    table = default_mode_table(30)
    f_np = default_frequencies(args.Tobs, args.dt)
    f_np = f_np[f_np > 0][::args.downsample]
    pro_inj = waveform_prologue(
        args.M, args.mu, p0, args.e0, np.pi / 4, np.pi / 3, 1.0, 1.0, 2.0, t_years=args.Tobs,
        table=table, k_max=args.kmax, eps=args.eps, max_steps=args.max_steps, flux_grid=grid,
        device=dev, **phys)
    table_t = table.take(pro_inj.sel.idx[0].cpu().numpy())
    prologue = emri_pe.template_prologue(args, table_t, np.arange(table_t.num_modes),
                                         flux_grid=grid, device=dev)
    transform = TransformContainer(
        parameter_transforms={(0, 1): lambda lm, le: [torch.exp(lm), torch.exp(lm) * torch.exp(le)]},
        fill_dict={"ndim_full": 14,
                   "fill_values": np.array([0.0, 1.0, 1.0, np.pi / 4, np.pi / 3, np.pi / 5,
                                            np.pi / 6, 0.0]),
                   "fill_inds": np.array([2, 5, 6, 7, 8, 9, 10, 12])})
    truth = np.array([np.log(args.M), np.log(args.mu / args.M), p0, args.e0, 1.0, 2.0])
    x = truth + np.random.default_rng(1).normal(0, 1, (16, 6)) * (np.abs(truth) * 1e-7 + 1e-9)
    p14 = transform.both_transforms(torch.as_tensor(x))
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    def run(p):
        pro = prologue(p)
        out = fd_waveform_core(pro, table_t, len(f_np), channels=True, uniform=uniform,
                               out_f32=True)
        sync()
        return pro, out

    full_pro, full_out = run(p14)
    for b in (1, 2, 4, 8):
        for k in (0, 5):
            rows = [k] + [j for j in range(16) if j != k][: b - 1]
            pro, out = run(p14[rows])
            n, n_full = int(pro.n_live[0]), int(full_pro.n_live[k])
            m = min(n, n_full)
            print(f"[batch] B={b} walker {k}: live knots {n} (in the batch of 16: {n_full}); "
                  f"relative to the batch of 16: knot times "
                  f"{_rel(pro.t_knots[0, :m], full_pro.t_knots[k, :m]):.3e}, phase "
                  f"{_rel(pro.phi_phi[0, :m], full_pro.phi_phi[k, :m]):.3e}, amplitudes "
                  f"{_rel(pro.a_re[0, :m], full_pro.a_re[k, :m]):.3e}, Ylm "
                  f"{_rel(pro.y_plus[0][0], full_pro.y_plus[0][k]):.3e}, template "
                  f"{max(_rel(o[0], f[k]) for o, f in zip(out, full_out)):.3e} max/scale",
                  flush=True)


if __name__ == "__main__":
    main()
