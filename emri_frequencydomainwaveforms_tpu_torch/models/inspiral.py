"""Batched Schwarzschild eccentric flux inspirals.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.inspiral``:
`schwarz_ecc_flux_inspiral` integrates a walker batch of trajectories under
the Peters-Mathews flux or one of the multipole flux grids (`models.flux`),
either with the adaptive DP5 stepper at its own knots (``method="dp5"``) or
by the parallel-in-time quadrature of `models.trajectory_quad`
(``method="quad"``); `EMRIInspiral` is the reference's call signature over
it; `get_p_at_t` and `get_mu_at_t` bisect p0 or mu for a given inspiral
duration (always with DP5, as in the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing
from ..utils.constants import MTSUN_SI, YRSID_SI
from ..utils.device import resolve_device
from .flux import FluxGrid, default_flux_grid, inspiral_rhs, pn_flux_e_l, stop_condition
from .geodesic import separatrix
from .integrate import InspiralKnots, integrate_inspiral


class Trajectory(NamedTuple):
    """Sparse inspiral trajectories, (B, max_steps) per field (padded).

    ``x`` is constant 1 and ``Phi_theta`` constant 0 for
    Schwarzschild-eccentric orbits.
    """

    t: torch.Tensor  # seconds
    p: torch.Tensor
    e: torch.Tensor
    x: torch.Tensor
    Phi_phi: torch.Tensor
    Phi_theta: torch.Tensor
    Phi_r: torch.Tensor
    n: torch.Tensor  # (B,) live knot count


def _batch_f64(*xs, device=None):
    """Broadcast scalars / tensors to float64 (B,) tensors on one device
    (`resolve_device`: ``device``, else the first tensor's, else CUDA)."""
    device = resolve_device(device, *xs)
    ts = [torch.as_tensor(x, dtype=torch.float64, device=device).reshape(-1) for x in xs]
    return list(torch.broadcast_tensors(*ts))


# flux name -> (tail, factorized, rwz) rung of the multipole flux grid:
# "multipole_factorized" = tail + source/rho resummation, "multipole_rwz"
# adds the strong-field calibration
_FLUX_RUNGS = {
    "multipole": (False, False, False),
    "multipole_tail": (True, False, False),
    "multipole_factorized": (True, True, False),
    "multipole_rwz": (True, True, True),
}


def flux_model(flux: str, device, flux_grid: FluxGrid | None = None):
    """The dissipative model of a flux name, as `flux.inspiral_rhs` takes
    it: `pn_flux_e_l` for "pm", else the multipole `FluxGrid` of that rung
    (``flux_grid`` when given, else `default_flux_grid` on ``device``)."""
    if flux == "pm":
        return pn_flux_e_l
    if flux not in _FLUX_RUNGS:
        raise ValueError(f"flux={flux!r}: expected 'pm' or one of {sorted(_FLUX_RUNGS)}")
    if flux_grid is not None:
        return flux_grid
    return default_flux_grid(*_FLUX_RUNGS[flux], device=device)


def schwarz_ecc_flux_inspiral(
    mass_1,
    mass_2,
    p0,
    e0,
    *,
    t_years: float = 1.0,
    Phi_phi0=0.0,
    Phi_r0=0.0,
    max_steps: int = 512,
    rtol: float = 1e-11,
    delta_p_stop: float = 0.12,
    flux: str = "pm",
    flux_grid: FluxGrid | None = None,
    method: str = "dp5",
    device=None,
) -> Trajectory:
    """Integrate a batch of Schwarzschild eccentric flux inspirals.

    Args:
      mass_1, mass_2: central and secondary masses [solar masses].
      p0, e0: initial semi-latus rectum / eccentricity, scalars or (B,).
      t_years: observation horizon [sidereal years].
      flux: dissipative model: "pm" (Peters-Mathews quadrupole),
        "multipole" (the mode-sum flux grid, energy-balanced with the
        waveform's multipole content), "multipole_tail" (with the |T_lm|^2
        wave-tail enhancement), "multipole_factorized" (tail + effective
        source + rho_lm resummation) or "multipole_rwz" (additionally the
        rwz strong-field calibration).
      flux_grid: the multipole grid to interpolate instead of the default
        one of that rung (`flux.default_flux_grid`, built on first use).
      method: "dp5" (the adaptive stepper, one host sync per step) or
        "quad" (`trajectory_quad`: p as the clock, a fixed-depth pass with
        no host sync; every one of the ``max_steps`` knots live).
      device: where to run; default the first tensor argument's device, else
        the current CUDA device (raises without one: pass device="cpu").

    Returns:
      Trajectory with t in seconds; each lane stops at min(T, separatrix).
    """
    if method == "quad":
        from .trajectory_quad import schwarz_ecc_flux_inspiral_quad

        with tracing.span("trajectory.quad"):
            return schwarz_ecc_flux_inspiral_quad(
                mass_1, mass_2, p0, e0, t_years=t_years, Phi_phi0=Phi_phi0, Phi_r0=Phi_r0,
                max_steps=max_steps, delta_p_stop=delta_p_stop, flux=flux, flux_grid=flux_grid,
                device=device,
            )
    if method != "dp5":
        raise ValueError(f"method={method!r}: expected 'dp5' or 'quad'")
    with tracing.span("trajectory.dp5"):
        m, mu, p0, e0, ph0, pr0 = _batch_f64(mass_1, mass_2, p0, e0, Phi_phi0, Phi_r0,
                                             device=device)
        flux_fn = flux_model(flux, p0.device, flux_grid)
        nu = mu / m
        t_max_geo = t_years * YRSID_SI / (m * MTSUN_SI)
        y0 = torch.stack([p0, e0, ph0, pr0], dim=-1)
        knots: InspiralKnots = integrate_inspiral(
            lambda y: inspiral_rhs(y, nu, flux_fn),
            lambda y: stop_condition(y, delta_p_stop),
            y0,
            t_max_geo,
            max_steps=max_steps,
            rtol=rtol,
            tail_slope_mask=(0.0, 0.0, 1.0, 1.0),
        )
        t_sec = knots.t * (m * MTSUN_SI)[:, None]
        return Trajectory(
            t=t_sec,
            p=knots.y[..., 0],
            e=knots.y[..., 1],
            x=torch.ones_like(knots.t),
            Phi_phi=knots.y[..., 2],
            Phi_theta=torch.zeros_like(knots.t),
            Phi_r=knots.y[..., 3],
            n=knots.n,
        )


class EMRIInspiral:
    """The reference's trajectory call signature, one source per call.

    ``traj(M, mu, a, p0, e0, x0, T=...)`` returns ``(t, p, e, x, Phi_phi,
    Phi_theta, Phi_r)``, each trimmed on the host to the live knots; the
    spin and inclination are inert for Schwarzschild-eccentric orbits.
    ``max_steps`` and ``rtol`` given to the constructor reach the
    trajectory, and so does ``device`` (default: the current CUDA device).
    """

    def __init__(self, func: str = "SchwarzEccFlux", device=None, **kwargs):
        if func != "SchwarzEccFlux":
            raise NotImplementedError(f"trajectory model {func!r} not implemented")
        self.device = device
        self.kwargs = kwargs

    def __call__(self, M, mu, a, p0, e0, x0, T=1.0, Phi_phi0=0.0, Phi_theta0=0.0, Phi_r0=0.0,
                 **kw):
        del a, x0, Phi_theta0
        traj = schwarz_ecc_flux_inspiral(
            M, mu, p0, e0, t_years=float(T), Phi_phi0=Phi_phi0, Phi_r0=Phi_r0,
            device=self.device,
            **{k: v for k, v in self.kwargs.items() if k in ("max_steps", "rtol")},
        )
        n = int(traj.n[0])
        return tuple(arr[0, :n] for arr in (traj.t, traj.p, traj.e, traj.x, traj.Phi_phi,
                                            traj.Phi_theta, traj.Phi_r))


def inspiral_duration(mass_1, mass_2, p0, e0, *, t_cap_years: float = 8.0,
                      max_steps: int = 512, flux: str = "pm",
                      flux_grid: FluxGrid | None = None, device=None) -> torch.Tensor:
    """Seconds until the separatrix cutoff (capped at t_cap_years), (B,)."""
    traj = schwarz_ecc_flux_inspiral(
        mass_1, mass_2, p0, e0, t_years=t_cap_years, max_steps=max_steps,
        flux=flux, flux_grid=flux_grid, device=device,
    )
    last = (traj.n - 1).clamp_min(0).long()
    return traj.t.gather(1, last[:, None])[:, 0]


@tracing.spanned("duration_solve")
def get_p_at_t(
    mass_1,
    mass_2,
    e0,
    t_out_years,
    *,
    p_lo: float | None = None,
    p_hi: float = 16.0,
    n_iters: int = 44,
    max_steps: int = 512,
    flux: str = "pm",
    flux_grid: FluxGrid | None = None,
    device=None,
) -> torch.Tensor:
    """p0 such that the inspiral lasts ``t_out_years`` (batched bisection).

    Duration increases monotonically with p0, so fixed-count bisection
    converges to ~(p_hi - p_lo)/2^n_iters; every lane bisects at once.
    """
    m, mu, e0, t_out = _batch_f64(mass_1, mass_2, e0, t_out_years, device=device)
    t_target = t_out * YRSID_SI
    lo = torch.maximum(torch.full_like(e0, p_lo if p_lo is not None else 0.0), separatrix(e0) + 0.2)
    hi = torch.full_like(e0, p_hi)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        dur = inspiral_duration(m, mu, mid, e0, t_cap_years=8.0, max_steps=max_steps,
                                flux=flux, flux_grid=flux_grid)
        too_long = dur >= t_target
        lo, hi = torch.where(too_long, lo, mid), torch.where(too_long, mid, hi)
    return 0.5 * (lo + hi)


@tracing.spanned("duration_solve")
def get_mu_at_t(
    mass_1,
    p0,
    e0,
    t_out_years,
    *,
    mu_lo: float = 1.0,
    mu_hi: float = 1e4,
    n_iters: int = 44,
    max_steps: int = 512,
    device=None,
) -> torch.Tensor:
    """mu such that the inspiral lasts ``t_out_years`` (batched bisection on
    log mu, Peters-Mathews flux as in the reference).

    A larger mu inspirals faster, so the duration decreases monotonically
    with it.
    """
    m, p0, e0, t_out = _batch_f64(mass_1, p0, e0, t_out_years, device=device)
    t_target = t_out * YRSID_SI
    lo = torch.full_like(e0, mu_lo)
    hi = torch.full_like(e0, mu_hi)
    for _ in range(n_iters):
        mid = torch.sqrt(lo * hi)
        dur = inspiral_duration(m, mid, p0, e0, t_cap_years=8.0, max_steps=max_steps)
        too_long = dur >= t_target  # too long -> a larger mu
        lo, hi = torch.where(too_long, mid, lo), torch.where(too_long, hi, mid)
    return torch.sqrt(lo * hi)


__all__ = [
    "Trajectory",
    "flux_model",
    "schwarz_ecc_flux_inspiral",
    "EMRIInspiral",
    "inspiral_duration",
    "get_p_at_t",
    "get_mu_at_t",
]
