"""Batched waveform generation: prologue, FD and TD cores, facades.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.waveform``:
`waveform_prologue` (trajectory -> amplitudes -> Ylm -> mode selection),
`fd_waveform_core` (the banded uniform-grid branch and the general
sorted-grid branch), `fd_scalar_on_grid` / `fd_channels_on_grid` (any signed
grid), `td_waveform_core` (the dense time-domain sum), `band_offsets_for`,
`freeze_mode_selection` / `coverage_of`, `default_time_grid` /
`default_frequencies`, the detector-frame helpers, the user-facing facades
`FastSchwarzschildEccentricFlux` and `GenerateEMRIWaveform` (numpy complex
out, as the reference's), and `FrozenFDWaveform`, the ``nn.Module`` that
holds a walker batch's frozen slot layout and maps (p0, e0, theta, phi) to
the four float32 spectra — the counterpart of the reference benchmark's
``gen`` closure. The detector-frame angle convention is the reference's
(see its module docstring).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cubic_spline import fit_cubic_spline, spline_eval
from ..utils import tracing
from ..utils.constants import Gpc, MRSUN_SI, YRSID_SI
from ..utils.device import resolve_device
from ..utils.ylm import spin_weighted_ylm
from .amplitude import ModeTable, default_mode_table, family_constants, mode_amplitudes
from .flux import FluxGrid
from .geodesic import fundamental_frequencies_seconds
from .inspiral import _batch_f64, flux_model, schwarz_ecc_flux_inspiral
from .modeselect import SelectedModes, mode_power, select_modes, table_indices_for
from .rwz_calibration import rwz_rows as rwz_rows_of
from .summation_fd import fd_mode_sum, fd_mode_sum_uniform, prepare_fd_inputs
from .summation_td import td_mode_sum


class WaveformPrologue(NamedTuple):
    """Everything the summation kernels need, per walker (leading axis B)."""

    t_knots: torch.Tensor  # (B, K) seconds
    n_live: torch.Tensor  # (B,)
    phi_phi: torch.Tensor  # (B, K)
    phi_r: torch.Tensor
    a_re: torch.Tensor  # (B, K, M)
    a_im: torch.Tensor
    sel: SelectedModes  # (B, k) fields
    y_plus: tuple[torch.Tensor, torch.Tensor]  # (B, M)
    y_minus: tuple[torch.Tensor, torch.Tensor]
    t_end: torch.Tensor  # (B,)
    dist_factor: torch.Tensor  # (B,)


@tracing.spanned("waveform.prologue")
def waveform_prologue(
    mass_1,
    mass_2,
    p0,
    e0,
    theta,
    phi,
    dist,
    Phi_phi0,
    Phi_r0,
    *,
    t_years: float,
    table: ModeTable,
    k_max: int,
    eps: float,
    forced_idx=None,
    max_steps: int = 512,
    flux: str = "pm",
    tail: bool = False,
    factorized: bool = False,
    rwz: bool = False,
    family_c: torch.Tensor | None = None,
    flux_grid: FluxGrid | None = None,
    rwz_rows: tuple[torch.Tensor, torch.Tensor] | None = None,
    traj_method: str = "dp5",
    device=None,
) -> WaveformPrologue:
    """Trajectory + amplitudes + Ylm + mode selection for a walker batch.

    Source parameters are scalars or (B,) tensors. ``forced_idx`` keeps
    exactly the given candidate modes (shared by the batch); otherwise each
    lane keeps its top-``k_max`` modes masked to power fraction 1 - eps,
    ordered by band-start frequency. ``flux`` names the trajectory's
    dissipation model (`inspiral.schwarz_ecc_flux_inspiral`) and ``tail`` /
    ``factorized`` / ``rwz`` the amplitude rung (`amplitude.mode_amplitudes`);
    pair flux="multipole_rwz" with all three for the production physics.
    ``traj_method`` is the trajectory's method, "dp5" or "quad"
    (`inspiral.schwarz_ecc_flux_inspiral`).
    ``family_c``, ``flux_grid`` and ``rwz_rows`` hand in state a batch-frozen
    module already keeps on the device. ``device`` defaults to the first
    tensor argument's device, else the current CUDA device (raises without
    one: pass ``device="cpu"``).
    """
    m1, m2, p0, e0, theta, phi, dist, ph0, pr0 = _batch_f64(
        mass_1, mass_2, p0, e0, theta, phi, dist, Phi_phi0, Phi_r0, device=device
    )
    dev, dt = p0.device, p0.dtype
    traj = schwarz_ecc_flux_inspiral(
        m1, m2, p0, e0, t_years=t_years, Phi_phi0=ph0, Phi_r0=pr0,
        max_steps=max_steps, flux=flux, flux_grid=flux_grid, method=traj_method,
    )
    a_re, a_im = mode_amplitudes(
        traj.p, traj.e, table, tail=tail, factorized=factorized, rwz=rwz,
        family_c=family_c, rwz_rows=rwz_rows,
    )  # (B, K, M)

    with tracing.span("ylm"):
        yp_re, yp_im = spin_weighted_ylm(table.ls, table.ms, theta, phi)
        ym_re, ym_im = spin_weighted_ylm(table.ls, -table.ms, theta, phi)

    n_b, k_knots = traj.t.shape
    live = (torch.arange(k_knots, device=dev)[None, :] < traj.n[:, None]).to(dt)
    if forced_idx is not None:
        idx = torch.as_tensor(forced_idx, device=dev).long()
        k_sel = idx.shape[-1]
        sel = SelectedModes(
            idx=idx.expand(n_b, k_sel),
            mask=torch.ones((n_b, k_sel), dtype=dt, device=dev),
            power=torch.zeros((n_b, k_sel), dtype=dt, device=dev),
        )
    else:
        with tracing.span("selection"):
            power = mode_power(a_re, a_im, yp_re, yp_im, ym_re, ym_im, dt_weights=live)
            # slots ordered by band-start frequency so slot identity is stable
            # across the batch (shared window offsets)
            om_phi0, om_r0 = fundamental_frequencies_seconds(traj.p[:, 0], traj.e[:, 0], m1)
            ms = torch.as_tensor(table.ms.astype(np.float64), dtype=dt, device=dev)
            ns = torch.as_tensor(table.ns.astype(np.float64), dtype=dt, device=dev)
            f_start_key = (ms * om_phi0[:, None] + ns * om_r0[:, None]) / (2.0 * math.pi)
            sel = select_modes(power, k_max, eps, order_key=f_start_key)

    dist_factor = m2 * MRSUN_SI / (dist * Gpc)
    t_end = traj.t.gather(1, (traj.n - 1).clamp_min(0).long()[:, None])[:, 0]
    return WaveformPrologue(
        t_knots=traj.t,
        n_live=traj.n,
        phi_phi=traj.Phi_phi,
        phi_r=traj.Phi_r,
        a_re=a_re,
        a_im=a_im,
        sel=sel,
        y_plus=(yp_re, yp_im),
        y_minus=(ym_re, ym_im),
        t_end=t_end,
        dist_factor=dist_factor,
    )


def _sigma(table: ModeTable, device=None) -> torch.Tensor:
    # equatorial partner symmetry A_{l,-m,-n} = (-1)^l conj(A_{lmn})
    return torch.as_tensor(((-1.0) ** table.ls).astype(np.float64), device=device)


@tracing.spanned("waveform.core")
def fd_waveform_core(
    pro: WaveformPrologue,
    table: ModeTable,
    f_pos: torch.Tensor | int,
    channels: bool = True,
    uniform: tuple[float, float] | None = None,
    band_runs: int | None = None,
    bins_per_run: int = 64,
    band_offsets=None,
    turnover_slots: int = 0,
    negative_slots: int = 0,
    extra_band_runs: int | None = None,
    band_offsets_extra=None,
    out_f32: bool = False,
    nodes_per_segment: int = 32,
    bin_range: tuple[int, int] | None = None,
):
    """FD waveforms on positive frequencies, (B, nf) per output.

    channels=True: (hp_re, hp_im, hc_re, hc_im); channels=False:
    (pos_re, pos_im, negc_re, negc_im) with htilde(-f) = conj(negc).
    ``uniform=(f0, df)`` with ``f_pos[i] = f0 + i df`` selects the banded
    uniform-grid kernel (`fd_mode_sum_uniform`); that branch reads only the
    grid's length, so ``f_pos`` may be given as the length nf.
    ``uniform=None`` evaluates the general sorted-grid kernel
    (`fd_mode_sum`, ``nodes_per_segment`` nodes per trajectory segment) on
    the ascending positive frequencies ``f_pos`` (nf,), which the batch
    shares. ``bin_range=(lo, hi)`` (uniform branch only) computes bins
    lo <= i < hi of the grid, bit for bit as in the whole-grid call (a
    frequency shard; `fd_mode_sum_uniform`).
    """
    dev = pro.t_knots.device
    sig = _sigma(table, dev)
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    if channels:
        # W1 = (sigma Y^- + conj(Y^+))/2 ; W2 = i (sigma Y^- - conj(Y^+))/2
        w1 = ((sig * ymr + ypr) * 0.5, (sig * ymi - ypi) * 0.5)
        w2 = (-(sig * ymi + ypi) * 0.5, (sig * ymr - ypr) * 0.5)
        # negative-frequency (direct-term) branch weights: conj(w1), conj(w2)
        w1n = (w1[0], -w1[1])
        w2n = (w2[0], -w2[1])
    else:
        # W1 = sigma Y^- (htilde at +f); W2 = conj(Y^+) (conj of htilde at -f)
        w1 = (sig * ymr, sig * ymi)
        w2 = (ypr, -ypi)
        w1n = (ypr, ypi)
        w2n = (sig * ymr, -sig * ymi)

    # distance scaling folded into the per-mode weights
    d = pro.dist_factor[:, None]
    w1 = (w1[0] * d, w1[1] * d)
    w2 = (w2[0] * d, w2[1] * d)
    w1n = (w1n[0] * d, w1n[1] * d)
    w2n = (w2n[0] * d, w2n[1] * d)

    inp = prepare_fd_inputs(
        pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im,
        table, pro.sel, w1, w2, w1n=w1n, w2n=w2n,
    )
    if uniform is None:
        if bin_range is not None:
            raise ValueError("bin_range needs the uniform grid (uniform=(f0, df))")
        return fd_mode_sum(
            inp, torch.as_tensor(f_pos, dtype=pro.t_knots.dtype, device=dev),
            nodes_per_segment=nodes_per_segment, turnover_slots=turnover_slots,
            negative_slots=negative_slots,
        )
    f0, dfreq = uniform
    nf = f_pos if isinstance(f_pos, int) else f_pos.shape[-1]
    r_eff = uniform_bins_per_run(nf, bins_per_run, band_offsets)
    return fd_mode_sum_uniform(
        inp, f0, dfreq, nf, bins_per_run=r_eff, band_runs=band_runs,
        band_offsets=band_offsets, turnover_slots=turnover_slots,
        negative_slots=negative_slots, extra_band_runs=extra_band_runs,
        band_offsets_extra=band_offsets_extra,
        out_dtype=torch.float32 if out_f32 else None, bin_range=bin_range,
    )


def uniform_bins_per_run(nf: int, bins_per_run: int = 64, band_offsets=None) -> int:
    """The run size `fd_waveform_core` uses on a uniform grid of ``nf`` bins:
    ``bins_per_run`` with caller-supplied window offsets (they count runs of
    that size), else shrunk on small grids to max(1, min(bins_per_run,
    nf // 8192)). A frequency shard starts on a multiple of it."""
    if band_offsets is not None:
        return bins_per_run
    return max(1, min(bins_per_run, nf // 8192))


def _detect_uniform_grid(freq: np.ndarray):
    """Host-side grid classification for the banded uniform kernel.

    Returns ``(f_pos, f0, df, symmetric)`` when the positive part of ``freq``
    is uniformly spaced and the negative part (if any) mirrors it (the
    default odd fftshift grid and ``[::k]`` downsamples of its positive
    half); None for irregular grids (the general sorted-grid kernel).
    """
    freq = np.asarray(freq)
    pos = freq[freq > 0]
    if len(pos) < 2 or np.any(np.diff(pos) <= 0):
        return None
    df = pos[1] - pos[0]
    if not np.allclose(np.diff(pos), df, rtol=1e-9):
        return None
    neg = freq[freq < 0]
    symmetric = len(neg) > 0
    if symmetric and not np.allclose(neg[::-1], -pos[: len(neg)], rtol=1e-12):
        return None
    if symmetric and len(neg) != len(pos):
        return None
    return pos, float(pos[0]), float(df), symmetric


def _assemble_scalar(freq, pos_v, negc_v, symmetric):
    """htilde on the signed grid ``freq`` (numpy complex) from the positive
    branch ``pos_v`` and the conjugated negative branch ``negc_v``."""
    out = np.zeros(freq.shape, dtype=np.complex128)
    out[freq > 0] = pos_v
    if symmetric:
        out[freq < 0] = np.conj(negc_v)[::-1]
    return out


def _assemble_channels(freq, hp_pos, hc_pos, symmetric):
    """[h+~, hx~] on the signed grid ``freq`` (numpy complex); reality fills
    the negative frequencies of a symmetric grid."""
    hp = np.zeros(freq.shape, dtype=np.complex128)
    hc = np.zeros(freq.shape, dtype=np.complex128)
    hp[freq > 0] = hp_pos
    hc[freq > 0] = hc_pos
    if symmetric:
        hp[freq < 0] = np.conj(hp_pos)[::-1]
        hc[freq < 0] = np.conj(hc_pos)[::-1]
    return hp, hc


def _on_abs_grid(pro, table, freq, channels, turnover_slots, negative_slots):
    """The general kernel at |f| of a signed grid (sorted ascending for the
    kernel, then put back in ``freq``'s order): four (B, N) outputs."""
    freq = torch.as_tensor(freq, dtype=torch.float64, device=pro.t_knots.device)
    f_abs = torch.clamp_min(torch.abs(freq), 1e-300)
    order = torch.argsort(f_abs, stable=True)
    inv = torch.argsort(order, stable=True)
    outs = fd_waveform_core(
        pro, table, f_abs[order], channels=channels,
        turnover_slots=turnover_slots, negative_slots=negative_slots,
    )
    return freq, [o[:, inv] for o in outs]


def fd_scalar_on_grid(pro: WaveformPrologue, table: ModeTable, freq,
                      turnover_slots: int = 0, negative_slots: int = 0):
    """Scalar htilde = FT(h+ - i hx) on an arbitrary signed frequency grid.

    One general-kernel pass at |f| gives both branches: htilde(f>0) = pos,
    htilde(f<0) = conj(negc), htilde(0) = 0. Returns float64 (re, im), each
    (B, N).
    """
    freq, (pr, pi, nr, ni) = _on_abs_grid(pro, table, freq, False, turnover_slots,
                                          negative_slots)
    pos = freq > 0
    neg = freq < 0
    zero = torch.zeros((), dtype=pr.dtype, device=pr.device)
    re = torch.where(pos, pr, torch.where(neg, nr, zero))
    im = torch.where(pos, pi, torch.where(neg, -ni, zero))
    return re, im


def fd_channels_on_grid(pro: WaveformPrologue, table: ModeTable, freq,
                        turnover_slots: int = 0, negative_slots: int = 0):
    """[h+~, hx~] on an arbitrary signed grid (reality fills f < 0 bins).

    Returns ((hp_re, hp_im), (hc_re, hc_im)), each (B, N) float64.
    """
    freq, (hpr, hpi, hcr, hci) = _on_abs_grid(pro, table, freq, True, turnover_slots,
                                              negative_slots)
    neg = freq < 0
    zero = freq == 0
    sgn = torch.where(neg, -1.0, 1.0).to(hpr.dtype)
    z = torch.zeros((), dtype=hpr.dtype, device=hpr.device)
    return (
        (torch.where(zero, z, hpr), torch.where(zero, z, hpi * sgn)),
        (torch.where(zero, z, hcr), torch.where(zero, z, hci * sgn)),
    )


def knot_frequencies(pro: WaveformPrologue) -> tuple[np.ndarray, np.ndarray]:
    """(f_phi, f_r) in Hz at lane 0's knots (numpy), from the derivative of
    the not-a-knot phase splines the FD kernels use."""
    t = pro.t_knots[:1]
    two_pi = 2.0 * math.pi
    sp_pp = fit_cubic_spline(t, pro.phi_phi[:1], bc="not-a-knot")
    sp_pr = fit_cubic_spline(t, pro.phi_r[:1], bc="not-a-knot")
    return (
        (spline_eval(sp_pp, t, deriv=1)[0] / two_pi).cpu().numpy(),
        (spline_eval(sp_pr, t, deriv=1)[0] / two_pi).cpu().numpy(),
    )


def band_offsets_for(
    pro: WaveformPrologue,
    table: ModeTable,
    f0: float,
    df: float,
    bins_per_run: int,
    band_runs: int,
    margin_frac: float = 0.125,
) -> np.ndarray:
    """Shared per-slot window-start runs from a representative source.

    ``pro`` is a prologue whose lane 0 is the representative source; the
    offsets (k,) int32 are computed once per walker batch, with a margin
    that absorbs the band drift across the batch.
    """
    fphi, fr = knot_frequencies(pro)
    f_phi0, f_r0 = float(fphi[0]), float(fr[0])
    sel_idx = pro.sel.idx[0].cpu().numpy()
    m_sel = table.ms[sel_idx].astype(np.float64)
    n_sel = table.ns[sel_idx].astype(np.float64)
    f_start = m_sel * f_phi0 + n_sel * f_r0
    run_df = bins_per_run * df
    margin = int(band_runs * margin_frac)
    g0 = np.floor((f_start - f0) / run_df).astype(np.int32) - margin
    return np.maximum(g0, 0)


class FrozenSelection(NamedTuple):
    """Batch-shared mode-slot configuration for the banded FD fast path.

    Produced once per walker batch by `freeze_mode_selection` from a
    representative source: the slot -> mode map (``forced_idx``), the shared
    window offsets and the window geometry. Per-lane eps selection shifts
    slot identity whenever a marginal mode crosses the eps boundary, so the
    production configuration freezes both and validates each batch with
    `coverage_of` (the frozen set must carry >= 1 - eps of each lane's mode
    power).
    """

    forced_idx: np.ndarray  # (k_slots,) candidate-table indices
    band_offsets: np.ndarray  # (k_slots,) window-start runs
    bins_per_run: int
    band_runs: int


def freeze_mode_selection(
    pro: WaveformPrologue,
    table: ModeTable,
    f0: float,
    df: float,
    *,
    k_slots: int | None = None,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    margin_frac: float = 0.125,
    drift_frac: float = 0.02,
) -> FrozenSelection:
    """Build the batch-shared slot layout from a representative prologue.

    ``pro`` is a `waveform_prologue` with eps selection whose lane 0 is the
    representative source (its ``sel`` orders live slots by band-start
    frequency). ``k_slots`` truncates to the leading slots (default: the
    live count + 2 margin slots); ``band_runs`` defaults to the widest
    selected band + offset margin + drift headroom, rounded up to a
    multiple of 64.
    """
    mask = pro.sel.mask[0].cpu().numpy()
    if k_slots is None:
        k_slots = min(int(mask.sum()) + 2, len(mask))
    forced = pro.sel.idx[0].cpu().numpy()[:k_slots]

    # band widths (in runs) of the kept slots, at the live knots
    fphi, fr = knot_frequencies(pro)
    n_liv = int(pro.n_live[0])
    ms = table.ms[forced].astype(np.float64)
    ns = table.ns[forced].astype(np.float64)
    fk = ms[:, None] * fphi[None, :n_liv] + ns[:, None] * fr[None, :n_liv]
    width_bins = (fk.max(axis=1) - fk[:, 0]) / df
    # the run size adapts to the narrowest band: the per-run interpolation
    # needs >= O(30) runs across a band
    bins_per_run = int(np.clip(width_bins.min() // 32, 1, bins_per_run))
    # margins scale with each band's absolute frequency position: across a
    # batch the band shifts by ~(parameter drift) x f
    pos_bins = (fk[:, 0] - f0) / df
    margin_bins = np.maximum(drift_frac * (pos_bins + width_bins), margin_frac * width_bins)
    if band_runs is None:
        need_bins = width_bins * (1.0 + drift_frac) + 2.0 * margin_bins
        band_runs = int(np.ceil(need_bins.max() / bins_per_run / 64.0) * 64)

    g0 = np.floor((pos_bins - margin_bins) / bins_per_run).astype(np.int32)
    return FrozenSelection(
        forced_idx=forced,
        band_offsets=np.maximum(g0, 0),
        bins_per_run=bins_per_run,
        band_runs=band_runs,
    )


def coverage_of(frozen: FrozenSelection, power: torch.Tensor) -> torch.Tensor:
    """Fraction of total mode power the frozen slot set carries.

    ``power``: (..., n_candidates) per-mode power (`modeselect.mode_power`
    along a lane's own trajectory). Gate batches with
    ``coverage_of(...) >= 1 - eps`` before trusting the frozen layout across
    a new posterior region.
    """
    idx = torch.as_tensor(np.asarray(frozen.forced_idx), device=power.device).long()
    return torch.sum(power[..., idx], dim=-1) / torch.sum(power, dim=-1)


def td_waveform_core(pro: WaveformPrologue, table: ModeTable, t_grid) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense TD waveforms (h_plus, h_cross), each (B, N), on ``t_grid``
    (N,) seconds, shared by the batch."""
    dev = pro.t_knots.device
    t_grid = torch.as_tensor(t_grid, dtype=pro.t_knots.dtype, device=dev)
    hp, hc = td_mode_sum(
        pro.t_knots, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im, table, pro.sel,
        pro.y_plus, pro.y_minus, t_grid, pro.t_end,
    )
    d = pro.dist_factor[:, None]
    return hp * d, hc * d


def default_time_grid(t_years: float, dt: float) -> np.ndarray:
    """Odd-length dense TD grid (reference ``odd_len=True`` semantics)."""
    n = int(t_years * YRSID_SI / dt)
    if n % 2 == 0:
        n += 1
    return np.arange(n) * dt


def default_frequencies(t_years: float, dt: float) -> np.ndarray:
    """fftshift(fftfreq(N, dt)) of the odd default grid."""
    n = default_time_grid(t_years, dt).shape[0]
    return np.fft.fftshift(np.fft.fftfreq(n, dt))


class FastSchwarzschildEccentricFlux:
    """Source-frame generator facade (the reference's call contract).

    One source per call; returns numpy complex arrays. ``inspiral_kwargs``
    takes ``method`` ("dp5", the default, or "quad"; see
    `inspiral.schwarz_ecc_flux_inspiral`) and ``max_steps`` (the
    trajectory's knot budget), ``amplitude_kwargs`` the rungs ``tail``,
    ``factorized`` and ``rwz`` (all on by default: the production physics),
    ``sum_kwargs`` ``output_type`` ("td" or "fd"; the grids are the odd
    ``default_time_grid`` / ``default_frequencies``), ``turnover_slots``
    (default 2 for FD output),
    ``negative_slots`` and ``flux`` (default "multipole_rwz"). ``device``
    defaults to the current CUDA device (raises without one: pass
    ``device="cpu"``). After an FD call ``.frequency`` holds the grid.
    """

    def __init__(
        self,
        inspiral_kwargs=None,
        amplitude_kwargs=None,
        Ylm_kwargs=None,
        sum_kwargs=None,
        use_gpu=None,
        n_max: int = 30,
        l_max: int = 6,
        k_max: int = 64,
        device=None,
    ):
        del Ylm_kwargs, use_gpu
        inspiral_kwargs = inspiral_kwargs or {}
        amplitude_kwargs = amplitude_kwargs or {}
        sum_kwargs = sum_kwargs or {}
        self.traj_method = inspiral_kwargs.get("method", "dp5")
        self.device = resolve_device(device)
        self.traj_max_steps = int(inspiral_kwargs.get("max_steps", 512))
        self.tail = bool(amplitude_kwargs.get("tail", True))
        self.factorized = bool(amplitude_kwargs.get("factorized", True))
        self.rwz = bool(amplitude_kwargs.get("rwz", True))
        self.output_type = sum_kwargs.get("output_type", "td")
        default_ts = 2 if self.output_type == "fd" else 0
        self.turnover_slots = int(sum_kwargs.get("turnover_slots", default_ts))
        self.negative_slots = int(sum_kwargs.get("negative_slots", 0))
        self.flux = sum_kwargs.get("flux", "multipole_rwz")
        self.table = default_mode_table(n_max, l_max=l_max)
        self.k_max = k_max
        self.frequency = None

    def __call__(
        self,
        M,
        mu,
        p0,
        e0,
        theta,
        phi,
        *,
        dist=1.0,
        T=1.0,
        dt=10.0,
        eps=1e-5,
        mode_selection=None,
        f_arr=None,
        mask_positive=False,
        Phi_phi0=0.0,
        Phi_r0=0.0,
        return_channels=False,
    ):
        forced = (
            table_indices_for(self.table, mode_selection) if mode_selection is not None else None
        )
        pro = waveform_prologue(
            M, mu, p0, e0, theta, phi, dist, Phi_phi0, Phi_r0,
            t_years=float(T), table=self.table,
            k_max=len(forced) if forced is not None else self.k_max,
            eps=eps, forced_idx=forced, flux=self.flux, tail=self.tail,
            factorized=self.factorized, rwz=self.rwz, max_steps=self.traj_max_steps,
            traj_method=self.traj_method, device=self.device,
        )

        def host(x):
            return x[0].cpu().numpy()

        if self.output_type == "td":
            hp, hc = td_waveform_core(pro, self.table, default_time_grid(float(T), float(dt)))
            if return_channels:
                return [host(hp), host(hc)]
            return host(hp) - 1j * host(hc)
        # FD on the default symmetric grid or an arbitrary user f_arr
        freq = default_frequencies(float(T), float(dt)) if f_arr is None else np.asarray(f_arr)
        self.frequency = freq
        uni = _detect_uniform_grid(freq)
        keep = freq >= 0
        if uni is not None:
            f_pos_np, f0, dfreq, symmetric = uni
            o1r, o1i, o2r, o2i = (host(o) for o in fd_waveform_core(
                pro, self.table, len(f_pos_np), channels=return_channels, uniform=(f0, dfreq),
                turnover_slots=self.turnover_slots, negative_slots=self.negative_slots,
            ))
            if return_channels:
                hp, hc = _assemble_channels(freq, o1r + 1j * o1i, o2r + 1j * o2i, symmetric)
                return [hp[keep], hc[keep]] if mask_positive else [hp, hc]
            out = _assemble_scalar(freq, o1r + 1j * o1i, o2r + 1j * o2i, symmetric)
            return out[keep] if mask_positive else out
        if return_channels:
            (hpr, hpi), (hcr, hci) = fd_channels_on_grid(
                pro, self.table, freq, turnover_slots=self.turnover_slots,
                negative_slots=self.negative_slots,
            )
            hp = host(hpr) + 1j * host(hpi)
            hc = host(hcr) + 1j * host(hci)
            return [hp[keep], hc[keep]] if mask_positive else [hp, hc]
        re, im = fd_scalar_on_grid(
            pro, self.table, freq, turnover_slots=self.turnover_slots,
            negative_slots=self.negative_slots,
        )
        out = host(re) + 1j * host(im)
        return out[keep] if mask_positive else out


def detector_frame_angles(qS, phiS, qK, phiK):
    """(theta, phi, psi): source-frame viewing angles and the polarization
    rotation, for scalars or (B,) tensors (float64, on the first tensor's
    device, else the CPU)."""
    dev = next((x.device for x in (qS, phiS, qK, phiK) if isinstance(x, torch.Tensor)), None)
    qS, phiS, qK, phiK = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (qS, phiS, qK, phiK))
    )

    def vec(x, y, z):
        return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    def unit(a):
        return a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)

    s_r = vec(torch.sin(qS) * torch.cos(phiS), torch.sin(qS) * torch.sin(phiS), torch.cos(qS))
    lhat = vec(torch.sin(qK) * torch.cos(phiK), torch.sin(qK) * torch.sin(phiK), torch.cos(qK))
    khat = -s_r  # propagation: source -> SSB
    theta = torch.arccos(torch.clamp(-dot(khat, lhat), -1.0, 1.0))

    # source-frame basis: z = Lhat, x = projection of the SSB z onto the plane
    zero, one = torch.zeros_like(qS), torch.ones_like(qS)
    zhat = vec(zero, zero, one)
    xs = zhat - dot(zhat, lhat)[..., None] * lhat
    xs_norm = torch.linalg.vector_norm(xs, dim=-1, keepdim=True)
    # degenerate when L || z: fall back to the SSB x-axis
    xs = torch.where(xs_norm > 1e-12, xs / torch.clamp_min(xs_norm, 1e-12), vec(one, zero, zero))
    ys = torch.linalg.cross(lhat, xs, dim=-1)
    view = s_r  # toward the observer, SSB coordinates
    phi = torch.arctan2(dot(view, ys), dot(view, xs))

    # polarization: source-frame transverse basis at the viewing point
    e_th_src = -unit(torch.linalg.cross(view, torch.linalg.cross(lhat, view, dim=-1), dim=-1))
    e_th_ssb = vec(torch.cos(qS) * torch.cos(phiS), torch.cos(qS) * torch.sin(phiS), -torch.sin(qS))
    e_ph_ssb = vec(-torch.sin(phiS), torch.cos(phiS), zero)
    psi = torch.arctan2(dot(e_th_src, e_ph_ssb), dot(e_th_src, e_th_ssb))
    return theta, phi, psi


def rotate_polarizations(hp, hc, psi):
    """[h+, hx] rotated by 2 psi: a tensor psi, or a float psi for pairs of
    any array type."""
    if isinstance(psi, torch.Tensor):
        c2, s2 = torch.cos(2.0 * psi), torch.sin(2.0 * psi)
    else:
        c2, s2 = math.cos(2.0 * psi), math.sin(2.0 * psi)
    return hp * c2 - hc * s2, hp * s2 + hc * c2


class GenerateEMRIWaveform:
    """Detector-frame 14-parameter facade: ``(M, mu, a, p0, e0, x0, dist,
    qS, phiS, qK, phiK, Phi_phi0, Phi_theta0, Phi_r0)`` -> [h+, hx] numpy
    complex arrays (``return_list``) or h+ - i hx. Keyword arguments as for
    `FastSchwarzschildEccentricFlux`."""

    def __init__(
        self,
        waveform_class: str = "FastSchwarzschildEccentricFlux",
        sum_kwargs=None,
        amplitude_kwargs=None,
        inspiral_kwargs=None,
        return_list: bool = False,
        use_gpu=None,
        frame: str = "detector",
        n_max: int = 30,
        l_max: int = 6,
        k_max: int = 64,
        device=None,
    ):
        if waveform_class != "FastSchwarzschildEccentricFlux":
            raise NotImplementedError(waveform_class)
        self.waveform_generator = FastSchwarzschildEccentricFlux(
            sum_kwargs=sum_kwargs, amplitude_kwargs=amplitude_kwargs,
            inspiral_kwargs=inspiral_kwargs, n_max=n_max, l_max=l_max, k_max=k_max,
            device=device,
        )
        self.return_list = return_list
        self.frame = frame
        # the reference exposes .waveform_generator.create_waveform.frequency
        self.waveform_generator.create_waveform = self.waveform_generator

    @property
    def frequency(self):
        return self.waveform_generator.frequency

    def __call__(
        self, M, mu, a, p0, e0, x0, dist, qS, phiS, qK, phiK, Phi_phi0, Phi_theta0, Phi_r0,
        *, T=1.0, dt=10.0, eps=1e-5, mode_selection=None, f_arr=None, mask_positive=False,
    ):
        del a, x0, Phi_theta0
        if self.frame == "source":
            theta, phi, psi = float(qS), float(phiS), 0.0
        else:
            theta, phi, psi = (float(x) for x in detector_frame_angles(qS, phiS, qK, phiK))
        hp, hc = self.waveform_generator(
            M, mu, p0, e0, theta, phi, dist=dist, T=T, dt=dt, eps=eps,
            mode_selection=mode_selection, f_arr=f_arr, mask_positive=mask_positive,
            Phi_phi0=Phi_phi0, Phi_r0=Phi_r0, return_channels=True,
        )
        # the same real rotation of the [h+, hx] pair per sample or bin
        hp2, hc2 = rotate_polarizations(hp, hc, psi)
        if self.return_list:
            return [hp2, hc2]
        return hp2 - 1j * hc2


class FrozenFDWaveform(torch.nn.Module):
    """Batch-frozen all-mode FD waveform generator.

    Holds the state a walker batch shares, as registered buffers: the mode
    table sliced to the frozen selection (``lmn``), its family constants,
    the forced slot indices, the shared window offsets of the main and
    extra slots and, for the physics above the flat rung, the multipole flux
    grid's values (``flux_values``, (96, 49, 2) float64) and the frozen
    table's ghost-padded calibration rows (``rwz_b_rows``, ``rwz_r_rows``).
    ``flux`` names the trajectory's dissipation model and ``tail`` /
    ``factorized`` / ``rwz`` the amplitude rung, as in `waveform_prologue`;
    the production physics is flux="multipole_rwz" with all three.
    ``forward(p0, e0, theta, phi)`` runs the prologue and the
    banded FD core for the batch and returns the four float32 spectra
    (hp_re, hp_im, hc_re, hc_im), each (B, nf), on the uniform grid
    f = f0 + i df. The buffers, and so the forward pass, live on ``device``:
    by default the current CUDA device (raises without one: pass
    ``device="cpu"``); ``.to()`` moves them as for any module.
    """

    def __init__(
        self,
        table: ModeTable,
        band_offsets,
        *,
        f0: float,
        df: float,
        nf: int,
        t_years: float,
        mass_1: float = 1e6,
        mass_2: float = 10.0,
        dist: float = 1.0,
        max_steps: int = 192,
        bins_per_run: int = 64,
        band_runs: int = 256,
        turnover_slots: int = 2,
        extra_band_runs: int = 64,
        band_offsets_extra=None,
        flux: str = "pm",
        tail: bool = False,
        factorized: bool = False,
        rwz: bool = False,
        flux_grid: FluxGrid | None = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.table = table
        self.flux = flux
        self.tail, self.factorized, self.rwz = bool(tail), bool(factorized), bool(rwz)
        self.f0, self.df, self.nf = float(f0), float(df), int(nf)
        self.t_years = float(t_years)
        self.mass_1, self.mass_2, self.dist = float(mass_1), float(mass_2), float(dist)
        self.max_steps = int(max_steps)
        self.bins_per_run, self.band_runs = int(bins_per_run), int(band_runs)
        self.turnover_slots, self.extra_band_runs = int(turnover_slots), int(extra_band_runs)
        if band_offsets_extra is None:
            band_offsets_extra = np.zeros((turnover_slots,), np.int32)
        lmn = np.stack([table.ls, table.ms, table.ns], axis=-1)
        self.register_buffer("lmn", torch.as_tensor(lmn, dtype=torch.int64, device=dev))
        self.register_buffer("family_c", torch.as_tensor(family_constants(table), device=dev))
        self.register_buffer(
            "forced_idx", torch.arange(table.num_modes, dtype=torch.int64, device=dev)
        )
        self.register_buffer(
            "band_offsets", torch.as_tensor(band_offsets, dtype=torch.int32, device=dev)
        )
        self.register_buffer(
            "band_offsets_extra", torch.as_tensor(band_offsets_extra, dtype=torch.int32, device=dev)
        )
        # the multipole flux grid (None under "pm"): its values move with the
        # module, its spacing stays on the host
        grid = flux_model(flux, dev, flux_grid)
        if not isinstance(grid, FluxGrid):
            grid = None
        self._flux_axes = grid[:4] if grid else None
        self.register_buffer("flux_values", grid.values.to(dev) if grid else None)
        b_rows, r_rows = rwz_rows_of(table.ls, table.ms, table.ns, dev) if rwz else (None, None)
        self.register_buffer("rwz_b_rows", b_rows)
        self.register_buffer("rwz_r_rows", r_rows)

    def flux_grid(self) -> FluxGrid | None:
        """The module's multipole flux grid on its buffers' device (None
        under the Peters-Mathews flux)."""
        return FluxGrid(*self._flux_axes, self.flux_values) if self._flux_axes else None

    @tracing.spanned("waveform.batch")
    def forward(self, p0, e0, theta, phi):
        pro = waveform_prologue(
            self.mass_1, self.mass_2, p0, e0, theta, phi, self.dist, 0.0, 0.0,
            t_years=self.t_years, table=self.table, k_max=self.table.num_modes, eps=0.0,
            max_steps=self.max_steps, forced_idx=self.forced_idx, family_c=self.family_c,
            flux=self.flux, tail=self.tail, factorized=self.factorized, rwz=self.rwz,
            flux_grid=self.flux_grid(),
            rwz_rows=(self.rwz_b_rows, self.rwz_r_rows) if self.rwz else None,
            device=self.lmn.device,
        )
        return fd_waveform_core(
            pro, self.table, self.nf, channels=True, uniform=(self.f0, self.df),
            band_runs=self.band_runs, band_offsets=self.band_offsets,
            bins_per_run=self.bins_per_run, turnover_slots=self.turnover_slots,
            extra_band_runs=self.extra_band_runs,
            band_offsets_extra=self.band_offsets_extra, out_f32=True,
        )


__all__ = [
    "WaveformPrologue",
    "waveform_prologue",
    "fd_waveform_core",
    "fd_scalar_on_grid",
    "fd_channels_on_grid",
    "td_waveform_core",
    "knot_frequencies",
    "band_offsets_for",
    "FrozenSelection",
    "freeze_mode_selection",
    "coverage_of",
    "default_time_grid",
    "default_frequencies",
    "FastSchwarzschildEccentricFlux",
    "GenerateEMRIWaveform",
    "detector_frame_angles",
    "rotate_polarizations",
    "FrozenFDWaveform",
]
