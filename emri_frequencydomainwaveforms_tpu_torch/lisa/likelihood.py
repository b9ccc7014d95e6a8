"""Noise-weighted likelihood over frequency-domain channels, per walker batch.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.likelihood``
(`df_vector`, `Likelihood`, `GlobalLikelihood`): the PSD comes from ``noise_fn(freqs)``, the
spacing is the right-rule df vector, the injection is pre-whitened by
sqrt(df / PSD), and ``log L = -1/2 * 4 * sum |d - h|^2`` over the whitened
channels.

The template contract is batched where the reference vmaps a single-walker
template: ``template(params_full)`` takes (n, ndim_full) float64 parameters
(already transformed) and returns ``nchannels`` pairs ``(re, im)`` of (n, nf)
spectra on ``f_arr``, in float32 or float64. The spectra are cast to float64
before whitening, and every reduction runs in float64 on the likelihood's
device. ``subset`` evaluates the walkers in chunks of that many (each
walker's value does not depend on the chunk it is in). `GlobalLikelihood`
sums the templates of the rows of each group (the sources of one walker)
before the residual.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.row_ops import row_sum
from ..utils import tracing
from ..utils.device import resolve_device


def df_vector(f_arr):
    """Right-rule spacings with df[0] = df[1] (numpy)."""
    f_arr = np.asarray(f_arr)
    if f_arr.shape[0] < 2:
        return np.ones_like(f_arr)
    d = np.diff(f_arr)
    return np.concatenate([d[:1], d])


class Likelihood:
    """Whitened-residual log-likelihood over FD channels.

    Args:
      template_model: ``(n, ndim_full) -> [(re, im), ...]`` of (n, nf) each,
        evaluated on ``f_arr`` (see the module docstring).
      nchannels: number of data channels (2 for [h+, hx]).
      f_arr: (nf,) positive frequencies of the analysis grid.
      parameter_transforms: a `TransformContainer` applied to the sampled
        parameters before the template.
      subset: optional chunk size for walker micro-batching.
      device: where the whitened data live and the reductions run; default
        the current CUDA device (raises without one: pass ``device="cpu"``).
    """

    def __init__(
        self,
        template_model: Callable,
        nchannels: int,
        *,
        f_arr,
        dt: float | None = None,
        parameter_transforms=None,
        subset: int | None = None,
        vectorized: bool = True,
        separate_d_h: bool = False,
        use_gpu=None,
        device=None,
    ):
        del dt, vectorized, separate_d_h, use_gpu
        self.device = resolve_device(device, f_arr)
        self.template_model = template_model
        self.nchannels = nchannels
        self.f_np = (f_arr.detach().cpu().numpy() if isinstance(f_arr, torch.Tensor)
                     else np.asarray(f_arr, dtype=np.float64))
        self.f_arr = torch.as_tensor(self.f_np, dtype=torch.float64, device=self.device)
        self.transform = parameter_transforms
        self.subset = subset
        self.noise_factor = None
        self.injection_whitened = None
        self._last_params = None

    # ---- injection ----
    def inject_signal(
        self,
        data_stream: Sequence,
        noise_fn=None,
        noise_args=(),
        noise_kwargs=None,
        add_noise: bool = False,
        seed: int | None = None,
    ):
        """Store the whitened injection and the whitening vector.

        ``data_stream``: ``nchannels`` complex numpy arrays on ``f_arr``.
        The PSD is evaluated on the host in float64 (``noise_fn`` of the
        numpy frequencies, default `get_sensitivity`); bins where it is not
        finite and positive get zero weight. ``add_noise`` adds Gaussian
        noise of that PSD, drawn with ``numpy.random.default_rng(seed)``.
        """
        from .sensitivity import get_sensitivity

        noise_kwargs = noise_kwargs or {}
        noise_fn = noise_fn or get_sensitivity
        f_np = self.f_np
        psd = np.asarray(noise_fn(f_np, *noise_args, **noise_kwargs), dtype=np.float64)
        dfv = df_vector(f_np)
        # non-finite PSD values would silently zero the whitening and fake a
        # perfect likelihood
        bad = ~np.isfinite(psd) | (psd <= 0)
        if bad.all():
            raise ValueError("noise PSD non-finite/non-positive on every bin")
        psd = np.where(bad, np.inf, psd)
        wf = np.sqrt(dfv / psd)
        self.noise_factor = torch.as_tensor(wf, device=self.device)

        chans = [np.asarray(c) for c in data_stream]
        if add_noise:
            rng = np.random.default_rng(seed)
            for i, c in enumerate(chans):
                sigma = np.sqrt(psd / (4.0 * dfv))
                noise = sigma * (rng.standard_normal(c.shape)
                                 + 1j * rng.standard_normal(c.shape)) / np.sqrt(2.0)
                chans[i] = c + noise
        self.injection_whitened = [
            (torch.as_tensor(c.real * wf, device=self.device),
             torch.as_tensor(c.imag * wf, device=self.device))
            for c in chans
        ]

    # ---- evaluation ----
    def _template(self, params: torch.Tensor, bins=None):
        """Template channels [(re, im), ...], (n, nf) float64 each, on the
        likelihood's device; with ``bins=(lo, hi)`` the template is asked
        for those bins only (``template_model(full, bins=(lo, hi))``)."""
        full = self.transform.both_transforms(params) if self.transform is not None else params
        chans = self.template_model(full) if bins is None else self.template_model(full, bins=bins)
        return [(re.to(device=self.device, dtype=torch.float64),
                 im.to(device=self.device, dtype=torch.float64))
                for re, im in chans]

    def _channels(self, params: torch.Tensor, bins=None):
        """Whitened template channels [(re, im), ...], (n, nf) float64 each
        (n, hi - lo with ``bins``)."""
        wf = self.noise_factor if bins is None else self.noise_factor[bins[0]:bins[1]]
        return [(re * wf, im * wf) for re, im in self._template(params, bins)]

    def _chunks(self, params: torch.Tensor):
        n = params.shape[0]
        step = n if self.subset is None else max(int(self.subset), 1)
        return [params[i:i + step] for i in range(0, n, step)]

    @tracing.spanned("likelihood.power")
    def _power(self, chans, lo: int, hi: int) -> torch.Tensor:
        """sum over channels of sum_{lo <= i < hi} |d_i - h_i|^2 per row, from
        whitened template channels that cover those bins."""
        acc = torch.zeros((chans[0][0].shape[0],), dtype=torch.float64, device=self.device)
        for (d_re, d_im), (h_re, h_im) in zip(self.injection_whitened, chans):
            r_re = d_re[lo:hi] - h_re
            r_im = d_im[lo:hi] - h_im
            acc = acc + row_sum(r_re * r_re + r_im * r_im)
        return acc

    def residual_power(self, params, bins=None) -> torch.Tensor:
        """Whitened residual power sum |d - h|^2 over the channels and the bins
        ``bins=(lo, hi)`` (default: all) of each row of ``params``, (n,)
        float64; the template is evaluated on those bins only. log L is
        -2 x the power summed over all bins; a frequency shard's partial sum
        (`parallel.mesh`)."""
        if self.injection_whitened is None:
            raise RuntimeError("call inject_signal first")
        params = self._as_params(params)
        lo, hi = (0, self.f_arr.shape[0]) if bins is None else bins
        return self._power(self._channels(params, bins), lo, hi)

    def _ll(self, params: torch.Tensor) -> torch.Tensor:
        return -2.0 * self._power(self._channels(params), 0, self.f_arr.shape[0])

    def _dh(self, params: torch.Tensor):
        dh = torch.zeros((params.shape[0],), dtype=torch.float64, device=self.device)
        hh = torch.zeros_like(dh)
        for (d_re, d_im), (h_re, h_im) in zip(self.injection_whitened, self._channels(params)):
            dh = dh + row_sum(d_re * h_re + d_im * h_im)
            hh = hh + row_sum(h_re * h_re + h_im * h_im)
        return 4.0 * dh, 4.0 * hh

    def _as_params(self, params) -> torch.Tensor:
        p = torch.as_tensor(params, dtype=torch.float64)
        return p.reshape(1, -1) if p.dim() == 1 else p

    def get_ll(self, params, **kwargs):
        return self(params, **kwargs)

    @tracing.spanned("likelihood.call")
    def __call__(self, params, **waveform_kwargs) -> torch.Tensor:
        """log L of each row of ``params`` (n, ndim): (n,) float64 on the
        likelihood's device."""
        del waveform_kwargs  # fixed in the template
        if self.injection_whitened is None:
            raise RuntimeError("call inject_signal first")
        params = self._as_params(params)
        self._last_params = params
        return torch.cat([self._ll(p) for p in self._chunks(params)])

    def d_h_h_h(self, params):
        """Matched-filter components per walker: (<d|h>, <h|h>), each (n,).
        The whitened vectors absorb sqrt(df/PSD), so <a|b> = 4 sum Re[a* b]."""
        if self.injection_whitened is None:
            raise RuntimeError("call inject_signal first")
        parts = [self._dh(p) for p in self._chunks(self._as_params(params))]
        return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])

    @property
    def d_h(self):
        """<d|h> of the last ``__call__`` batch."""
        return self.d_h_h_h(self._last_params)[0]

    @property
    def h_h(self):
        """<h|h> of the last ``__call__`` batch."""
        return self.d_h_h_h(self._last_params)[1]


class GlobalLikelihood(Likelihood):
    """Grouped-template likelihood: the rows of one group are separate
    sources summed in the data model (the reversible-jump multi-source
    configuration).

    ``get_ll(params, groups)``: ``params`` (n, ndim) rows, ``groups`` (n,)
    group ids; the rows go through the template in one call per ``subset``
    chunk, each group's templates are summed, whitened and reduced, and
    the result is (max(groups) + 1,) float64 on the likelihood's device (a
    group with no row gets the data's own log L; a trailing one gets no
    entry, as in the reference). Without ``groups``, the per-row log L.
    """

    def get_ll(self, params, groups=None, **kwargs):
        if groups is None:
            return self(params, **kwargs)
        with tracing.span("likelihood.call"):
            return self._grouped_ll(params, groups)

    def _grouped_ll(self, params, groups) -> torch.Tensor:
        if self.injection_whitened is None:
            raise RuntimeError("call inject_signal first")
        params = self._as_params(params)
        groups = torch.as_tensor(groups, dtype=torch.long).reshape(-1).to(self.device)
        n_groups = int(groups.max()) + 1
        sums, lo = None, 0
        for p in self._chunks(params):
            g = groups[lo:lo + p.shape[0]]
            lo += p.shape[0]
            chans = self._template(p)
            if sums is None:
                sums = [tuple(torch.zeros((n_groups, x.shape[-1]), dtype=torch.float64,
                                          device=self.device) for x in ch) for ch in chans]
            for acc, ch in zip(sums, chans):
                for a, x in zip(acc, ch):
                    a.index_add_(0, g, x)
        wf = self.noise_factor
        ll = torch.zeros((n_groups,), dtype=torch.float64, device=self.device)
        for (d_re, d_im), (h_re, h_im) in zip(self.injection_whitened, sums):
            r_re = d_re - h_re * wf
            r_im = d_im - h_im * wf
            ll = ll + row_sum(r_re * r_re + r_im * r_im)
        return -2.0 * ll


__all__ = ["Likelihood", "GlobalLikelihood", "df_vector"]
