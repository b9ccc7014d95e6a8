"""The dp5 inspiral of a walker batch: the hand-written CUDA kernel of
``csrc/dp5_inspiral.cu`` and its plain version.

The plain version is `models.integrate.integrate_inspiral` over
`models.flux.inspiral_rhs`: one Python loop steps the whole batch, each step
~1,600 small float64 launches and one host read, so on the card the host
sets its pace. The kernel runs each lane's whole adaptive loop on the card,
one warp per lane, in one launch; it computes the plain version's knots
operation for operation (the source says how), so on the card the two agree
lane for lane and a lane's knots do not depend on its batch. It replaces no
TPU kernel: the JAX package's loop is a ``lax.while_loop`` under ``vmap``.

`dp5_inspiral` dispatches on the device of ``y0``: CPU tensors take the
plain version; CUDA tensors launch the kernel (built with nvcc at first use)
for the Peters-Mathews flux or a `FluxGrid`, and raise for any other flux
model. There is no fallback from the kernel to the plain version. Both end
in `integrate.pad_knots`, the tail past the live knots, whose phases continue
as a quadratic: the plain version takes its slope and curvature from a
``torch.func.jvp`` through the whole right-hand side (~1,800 launches on the
card, more host time than the kernel), the kernel path the slope from the
kernel (the rate at the last knot) and the curvature from a jvp through the
phases' rates alone, `flux.inspiral_phase_rates`: the same bits. Each launch adds one
to ``dp5_inspiral.launches``; with tracing on, a call adds the loop's
counters (``dp5.trips``: the most iterations of a lane, the trips the plain
loop makes; ``dp5.lane_slots``, ``dp5.accepted``, ``dp5.rejected``) with one
host read, and ``dp5.kernel_lanes``, the lanes the kernel integrated.

The Darwin sums inside the kernel add in `ops.row_ops.row_sum`'s order for
rows of `N_CHI` float64 elements, fixed by the constants below (the kernel's
own are checked against them and the row kernels' when the library loads).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.flux import (FluxGrid, inspiral_phase_rates, inspiral_rhs, pn_flux_e_l,
                           stop_condition)
from ..models.geodesic import _N_CHI, _chi
from ..models.integrate import InspiralKnots, integrate_inspiral, pad_knots
from ..utils import tracing
from . import cuda_build, row_ops

VECTOR_BYTES = 16  # row_sum's 16-byte groups: 2 float64 Darwin nodes per group
SMALL_MAX = 2048  # row_sum's one-warp regime, which N_CHI lies in
N_CHI = _N_CHI  # Darwin nodes per frequency evaluation
TAIL_SLOPE_MASK = (0.0, 0.0, 1.0, 1.0)  # the phases continue past the last knot, (p, e) stay
_PETERS_MATHEWS, _FLUX_GRID = 0, 1  # the kernel's FluxKind


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build and load ``csrc/dp5_inspiral.cu``, its order constants checked."""
    lib = ctypes.CDLL(cuda_build.build("dp5_inspiral")[0])
    lib.dp5_inspiral_constants.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.dp5_inspiral_constants.restype = None
    got = (ctypes.c_longlong * 3)()
    lib.dp5_inspiral_constants(got)
    row_ops._load()  # checks csrc/row_ops.cu's constants against ops/row_ops.py's
    want = (row_ops.VECTOR_BYTES, row_ops.SMALL_MAX, N_CHI)
    if tuple(got) != want or N_CHI > SMALL_MAX:
        raise RuntimeError(f"csrc/dp5_inspiral.cu's order constants {tuple(got)} differ from "
                           f"ops/row_ops.py's and the geodesic's {want}")
    p, ll, d, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_int
    model = [p, i, p, ll, ll, d, d, d, d]  # cos_chi, kind, grid, n_u, n_e, u0, 1/du, e0, 1/de
    lib.dp5_inspiral_f64.argtypes = ([p, p, p] + model + [ll, ll, ll, d, d, d, d, d]
                                     + [p, p, p, p, p, p])
    lib.dp5_rhs_f64.argtypes = [p, p] + model + [ll, p, p]
    lib.dp5_inspiral_f64.restype = lib.dp5_rhs_f64.restype = ctypes.c_int
    return lib


def _lanes(x, n_b: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) value as a contiguous float64 (B,) tensor on ``like``'s device."""
    x = torch.as_tensor(x, dtype=torch.float64, device=like.device)
    return torch.broadcast_to(x, (n_b,)).contiguous()


def _model_args(flux_fn, like: torch.Tensor) -> tuple[list, tuple]:
    """The kernel's model arguments for ``flux_fn`` on ``like``'s device, and
    the tensors they point into (kept alive by the caller until the launch)."""
    cos_chi = torch.cos(_chi(N_CHI, like))  # the plain version's node cosines
    if flux_fn is pn_flux_e_l:
        return [cos_chi.data_ptr(), _PETERS_MATHEWS, None, 0, 0, 0.0, 0.0, 0.0, 0.0], (cos_chi,)
    if not isinstance(flux_fn, FluxGrid):
        raise ValueError("dp5_inspiral on CUDA: the flux model must be pn_flux_e_l or a "
                         f"FluxGrid, got {flux_fn!r}")
    values = flux_fn.values
    if (values.device != like.device or values.dtype != torch.float64 or values.dim() != 3
            or values.shape[2] != 2 or min(values.shape[:2]) < 4):
        raise ValueError("dp5_inspiral on CUDA: the FluxGrid's values must be a (n_u >= 4, "
                         f"n_e >= 4, 2) float64 tensor on {like.device}, got "
                         f"{tuple(values.shape)} {values.dtype} on {values.device}")
    values = values.contiguous()
    # `(q - q0) / dq` with a Python float dq is a product with 1 / dq on CUDA
    args = [cos_chi.data_ptr(), _FLUX_GRID, values.data_ptr(), values.shape[0],
            values.shape[1], flux_fn.u0, 1.0 / flux_fn.du, flux_fn.e0, 1.0 / flux_fn.de]
    return args, (cos_chi, values)


def phase_slopes(k_last: torch.Tensor):
    """The kernel path's tail slopes for `pad_knots`, from the rate at each
    lane's last knot ``k_last`` (B, 4): the rate masked to the phases, and the
    phases' curvature, the derivative of their rates along ``k_last``. The
    plain version's full-RHS jvp gives the same bits."""
    mask = torch.as_tensor(TAIL_SLOPE_MASK, dtype=k_last.dtype, device=k_last.device)

    def slopes(last_y):
        _, acc_phases = torch.func.jvp(inspiral_phase_rates, (last_y,), (k_last,))
        acc = torch.zeros_like(k_last)
        # where the derivative leaves the bound-orbit domain: linear continuation
        acc[:, 2:] = torch.where(torch.isfinite(acc_phases), acc_phases,
                                 torch.zeros_like(acc_phases))
        return k_last * mask, acc

    return slopes


def dp5_inspiral_reference(y0, t_max, nu, flux_fn, *, delta_p_stop: float, max_steps: int,
                           rtol: float, atol: float = 1e-11, h0: float = 100.0,
                           h_max_frac: float = 1.0 / 128.0,
                           max_iters: int | None = None) -> InspiralKnots:
    """The plain version: `integrate_inspiral` over `inspiral_rhs`, on any device."""
    return integrate_inspiral(
        lambda y: inspiral_rhs(y, nu, flux_fn),
        lambda y: stop_condition(y, delta_p_stop),
        y0, t_max, max_steps=max_steps, rtol=rtol, atol=atol, h0=h0, h_max_frac=h_max_frac,
        max_iters=max_iters, tail_slope_mask=TAIL_SLOPE_MASK,
    )


def dp5_inspiral(y0: torch.Tensor, t_max, nu, flux_fn, *, delta_p_stop: float,
                 max_steps: int, rtol: float, atol: float = 1e-11, h0: float = 100.0,
                 h_max_frac: float = 1.0 / 128.0, max_iters: int | None = None) -> InspiralKnots:
    """Integrate ``d/dt [p, e, Phi_phi, Phi_r] = inspiral_rhs(y, nu, flux_fn)``
    per lane from ``y0`` (B, 4) at t = 0 until the stop surface (p at
    ``delta_p_stop`` above the separatrix) or ``t_max`` (scalar or (B,),
    geometric time); ``nu`` is the mass ratio, scalar or (B,); ``flux_fn``
    `pn_flux_e_l` or a `FluxGrid` (on the CPU, any model `inspiral_rhs`
    takes). Step options as `integrate_inspiral`'s.
    """
    kw = dict(delta_p_stop=delta_p_stop, max_steps=max_steps, rtol=rtol, atol=atol, h0=h0,
              h_max_frac=h_max_frac, max_iters=max_iters)
    if y0.device.type == "cpu":
        return dp5_inspiral_reference(y0, t_max, nu, flux_fn, **kw)
    if y0.device.type != "cuda":
        raise ValueError(f"dp5_inspiral: unsupported device {y0.device}")
    if y0.dtype != torch.float64 or y0.dim() != 2 or y0.shape[1] != 4:
        raise ValueError(f"dp5_inspiral: y0 must be (B, 4) float64, got {tuple(y0.shape)} "
                         f"{y0.dtype}")
    if max_steps < 1:
        raise ValueError(f"dp5_inspiral: max_steps must be at least 1, got {max_steps}")
    if max_iters is None:
        max_iters = 4 * max_steps
    n_b = y0.shape[0]
    y0 = y0.contiguous()
    t_max, nu = _lanes(t_max, n_b, y0), _lanes(nu, n_b, y0)
    t_buf = torch.empty((n_b, max_steps), dtype=torch.float64, device=y0.device)
    y_buf = torch.empty((n_b, max_steps, 4), dtype=torch.float64, device=y0.device)
    k_last = torch.empty((n_b, 4), dtype=torch.float64, device=y0.device)
    n = torch.empty((n_b,), dtype=torch.int32, device=y0.device)
    iters = torch.empty_like(n)
    if n_b:
        model, keep = _model_args(flux_fn, y0)
        lib = _library()
        with torch.cuda.device(y0.device):
            err = lib.dp5_inspiral_f64(
                y0.data_ptr(), t_max.data_ptr(), nu.data_ptr(), *model, n_b, max_steps,
                max_iters, rtol, atol, h0, h_max_frac, delta_p_stop, t_buf.data_ptr(),
                y_buf.data_ptr(), k_last.data_ptr(), n.data_ptr(), iters.data_ptr(),
                torch.cuda.current_stream(y0.device).cuda_stream)
        del keep
        if err != 0:
            raise RuntimeError(f"dp5_inspiral kernel launch failed: cudaError {err}")
        dp5_inspiral.launches += 1
    if tracing.active():
        it = iters.long()
        trips, lane_iters, knots = (torch.stack([it.max(), it.sum(), n.long().sum()]).tolist()
                                    if n_b else (0, 0, 0))
        accepted = knots - n_b
        tracing.count("dp5.trips", trips)
        tracing.count("dp5.lane_slots", n_b * trips)
        tracing.count("dp5.accepted", accepted)
        tracing.count("dp5.rejected", lane_iters - accepted)
        tracing.count("dp5.kernel_lanes", n_b)
    return pad_knots(t_buf, y_buf, n, phase_slopes(k_last))


dp5_inspiral.launches = 0


def dp5_rhs(y: torch.Tensor, nu, flux_fn) -> torch.Tensor:
    """The kernel's right-hand side alone on CUDA tensors: `inspiral_rhs(y,
    nu, flux_fn)` for (N, 4) float64 states, one warp per state (a test aid;
    the card tests hold it to `inspiral_rhs` to the bit)."""
    if y.device.type != "cuda" or y.dtype != torch.float64 or y.dim() != 2 or y.shape[1] != 4:
        raise ValueError(f"dp5_rhs: expected (N, 4) float64 CUDA states, got "
                         f"{tuple(y.shape)} {y.dtype} on {y.device}")
    y = y.contiguous()
    nu = _lanes(nu, y.shape[0], y)
    out = torch.empty_like(y)
    if y.shape[0]:
        model, keep = _model_args(flux_fn, y)
        with torch.cuda.device(y.device):
            err = _library().dp5_rhs_f64(y.data_ptr(), nu.data_ptr(), *model, y.shape[0],
                                         out.data_ptr(),
                                         torch.cuda.current_stream(y.device).cuda_stream)
        del keep
        if err != 0:
            raise RuntimeError(f"dp5_rhs kernel launch failed: cudaError {err}")
    return out


__all__ = ["dp5_inspiral", "dp5_inspiral_reference", "dp5_rhs", "VECTOR_BYTES", "SMALL_MAX",
           "N_CHI"]
