"""Relative-binning (heterodyned) likelihood.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.relbin``: the
Zackay-Dalal-Venumadhav scheme, waveform-agnostic. Near a fiducial waveform
h0 the ratio r(f) = h(f) / h0(f) is smooth, so the full-grid inner products
collapse onto per-bin summary coefficients

  A0_b = 4 sum_{f in b} df d conj(h0) / S,   A1_b = ... (f - fbar_b) ...
  B0_b = 4 sum_{f in b} df |h0|^2 / S,       B1_b = ... (f - fbar_b) ...

  <d|h> ~= Re sum_b [A0_b conj(r_b) + A1_b conj(r'_b)]
  <h|h> ~= sum_b [B0_b |r_b|^2 + 2 B1_b Re(r_b conj(r'_b))]

with r_b the bin-centre ratio and r'_b its slope from the bin-edge values,
so a template is evaluated at only ``nbins + 1`` frequencies per call.

The set-up (bin edges, summaries) is host numpy float64, as in the
reference. The per-call core runs on (re, im) float64 tensors on
``device``, batched over a leading walker axis where the reference vmaps.
It keeps the reference's live-bin mask and per-channel scale: harmless in
float64, and what makes the two agree bin for bin.

Scope, as in the reference: the scheme needs h/h0 smooth over a coarse
bin, true for single-chirp signals, not for multi-harmonic EMRI waveforms
(overlapping mode bands make the ratio oscillate within a bin); EMRI PE
uses the downsampled ``f_arr`` likelihood (`lisa.likelihood`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.device import resolve_device


def select_bin_edges(f_dense: np.ndarray, max_bins: int = 512,
                     gammas=(-5.0 / 3.0, -2.0 / 3.0, 1.0, 5.0 / 3.0, 7.0 / 3.0)):
    """Indices into ``f_dense`` of the bin edges: equal increments of the
    summed normalized variation of the power laws f^gamma (a PN-like phase
    budget per bin), at most ``max_bins`` bins."""
    f = np.asarray(f_dense, dtype=np.float64)
    fmin, fmax = f[0], f[-1]
    t = np.zeros_like(f)
    for g in gammas:
        t = t + np.abs(f**g - fmin**g) / max(abs(fmax**g - fmin**g), 1e-300)
    t = t / t[-1]
    idx = np.unique(np.searchsorted(t, np.linspace(0.0, 1.0, max_bins + 1)))
    idx[0] = 0
    idx[-1] = len(f) - 1
    return np.unique(idx)


def _bin_sum(bin_of, weights, nb):
    return np.bincount(bin_of, weights=weights, minlength=nb)


class RelativeBinningLikelihood:
    """Heterodyned log-likelihood around a fiducial waveform.

    Args:
      template_fn: ``params -> channels``, each channel an ``(re, im)`` pair
        evaluated at ``self.f_edges`` (nbins + 1 values); ``params`` is
        (..., ndim) and the channels (..., nbins + 1), tensors or arrays.
      f_dense: the dense analysis frequencies (the full likelihood grid).
      data: complex data channels on ``f_dense``.
      h0: complex fiducial channels on ``f_dense``.
      psd: PSD on ``f_dense`` (one array, or one per channel).
      max_bins: coarse bin budget.
      device: where the per-call core runs (default the current CUDA device;
        ``"cpu"`` on the CPU).
    """

    def __init__(self, template_fn: Callable, f_dense, data, h0, psd,
                 max_bins: int = 512, device=None):
        self.device = resolve_device(device)
        self.template_fn = template_fn
        f = np.asarray(f_dense, dtype=np.float64)
        data = [np.asarray(d) for d in data]
        h0 = [np.asarray(h) for h in h0]
        if not isinstance(psd, (list, tuple)):
            psd = [np.asarray(psd)] * len(data)
        psd = [np.asarray(p) for p in psd]

        df = np.empty_like(f)
        df[1:] = np.diff(f)
        df[0] = df[1] if len(f) > 1 else 1.0

        edge_idx = select_bin_edges(f, max_bins=max_bins)
        self.f_edges = f[edge_idx]
        nb = len(edge_idx) - 1
        self.nbins = nb
        # bin of every dense sample (the last bin right-closed)
        bin_of = np.clip(np.searchsorted(self.f_edges, f, side="right") - 1, 0, nb - 1)
        self.fbar = 0.5 * (self.f_edges[:-1] + self.f_edges[1:])
        dfreq = f - self.fbar[bin_of]

        a0, a1, b0, b1 = [], [], [], []
        self._dd = 0.0
        # samples where the fiducial vanishes carry data power the ratio
        # cannot represent: their residual |d - h0|^2 stays at the
        # fiducial's value (exact there, second order near it; empty for a
        # single-band chirp)
        self._resid0 = 0.0
        for d, h, p in zip(data, h0, psd):
            w = 4.0 * df / p
            dead = np.abs(h) == 0.0
            self._resid0 += float(np.sum(w[dead] * np.abs(d[dead]) ** 2))
            d = np.where(dead, 0.0, d)
            integ0 = w * d * np.conj(h)
            integ_b = w * np.abs(h) ** 2
            a0.append(_bin_sum(bin_of, integ0.real, nb) + 1j * _bin_sum(bin_of, integ0.imag, nb))
            a1.append(_bin_sum(bin_of, (integ0 * dfreq).real, nb)
                      + 1j * _bin_sum(bin_of, (integ0 * dfreq).imag, nb))
            b0.append(_bin_sum(bin_of, integ_b, nb))
            b1.append(_bin_sum(bin_of, integ_b * dfreq, nb))
            self._dd += float(np.sum(w * np.abs(d) ** 2))

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                                   device=self.device)

        self._a0 = [(dev(x.real), dev(x.imag)) for x in a0]
        self._a1 = [(dev(x.real), dev(x.imag)) for x in a1]
        self._b0 = [dev(x) for x in b0]
        self._b1 = [dev(x) for x in b1]
        # the ratio is scale-invariant: both sides are divided by a
        # per-channel scale, as in the reference
        self._scale = [float(np.median(np.abs(h[edge_idx])) + 1e-300) for h in h0]
        self._h0_edges = [(dev(h[edge_idx].real / s), dev(h[edge_idx].imag / s))
                          for h, s in zip(h0, self._scale)]
        self._df_bins = dev(np.diff(self.f_edges))
        self.f_edges_t = dev(self.f_edges)

    def _core(self, chans) -> torch.Tensor:
        """log L over the leading axes of the template channels."""
        out = 0.0
        for ci, (hr, hi) in enumerate(chans):
            inv_s = 1.0 / self._scale[ci]
            hr = torch.as_tensor(hr, dtype=torch.float64, device=self.device) * inv_s
            hi = torch.as_tensor(hi, dtype=torch.float64, device=self.device) * inv_s
            h0r, h0i = self._h0_edges[ci]
            den = h0r * h0r + h0i * h0i
            # dead fiducial edges carry no summary weight: their ratio is 0
            live = den > 1e-30
            den_safe = torch.where(live, den, torch.ones_like(den))
            zero = torch.zeros((), dtype=torch.float64, device=self.device)
            rr = torch.where(live, (hr * h0r + hi * h0i) / den_safe, zero)
            ri = torch.where(live, (hi * h0r - hr * h0i) / den_safe, zero)
            # bin-centre value and slope from the edge samples
            rbr = 0.5 * (rr[..., 1:] + rr[..., :-1])
            rbi = 0.5 * (ri[..., 1:] + ri[..., :-1])
            rpr = (rr[..., 1:] - rr[..., :-1]) / self._df_bins
            rpi = (ri[..., 1:] - ri[..., :-1]) / self._df_bins
            a0r, a0i = self._a0[ci]
            a1r, a1i = self._a1[ci]
            dh = torch.sum(a0r * rbr + a0i * rbi + a1r * rpr + a1i * rpi, dim=-1)
            hh = torch.sum(self._b0[ci] * (rbr * rbr + rbi * rbi)
                           + 2.0 * self._b1[ci] * (rbr * rpr + rbi * rpi), dim=-1)
            out = out + dh - 0.5 * hh
        return out - 0.5 * (self._dd + self._resid0)

    def logl(self, params) -> torch.Tensor:
        """Heterodyned log L = <d|h> - 0.5 <h|h> - 0.5 <d|d> of one source
        (a 0-d tensor), or of each row of a (n, ndim) batch."""
        return self._core(self.template_fn(params))

    def __call__(self, params_batch) -> torch.Tensor:
        """log L over a leading walker axis: (n, ndim) -> (n,); (ndim,) -> 0-d."""
        return self.logl(params_batch)


__all__ = ["RelativeBinningLikelihood", "select_bin_edges"]
