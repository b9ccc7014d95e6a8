"""Noise-weighted inner products, SNR, Fisher and covariance diagnostics.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.diagnostic``:
`inner_product`, `overlap`, `get_mismatch`, `snr`, `scale_snr`, and the
Fisher / Cramer-Rao set: `dh_dlambda` (central 5-point stencil), `fisher`,
`pinv_highprec` (mpmath, imported when called), `covariance`,
`mismatch_criterion`, `get_eigens`, `vallisneri_criterion[_cdf]` and
`cutler_vallisneri_bias`.

A waveform callable ``params -> channel or [channels]`` runs wherever it
runs: its channels may be numpy arrays or tensors on any device, and the
stencil combines them there. The inner products and the small matrix
algebra are host numpy float64 (one call per diagnostic, not in the
sampler's loop), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .sensitivity import get_sensitivity


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _as_channel_list(sig):
    """The channels of ``sig`` as host numpy arrays."""
    return [_host(s) for s in _channels(sig)]


def _channels(sig) -> list:
    """The channels of ``sig`` as given (numpy arrays or tensors)."""
    return list(sig) if isinstance(sig, (list, tuple)) else [sig]


def _df_vector(f):
    """Right-rule frequency spacings with df[0] = df[1]."""
    f = np.asarray(f)
    df = np.empty_like(f)
    df[1:] = np.diff(f)
    df[0] = df[1] if len(f) > 1 else 1.0
    return df


def inner_product(
    sig1,
    sig2,
    *,
    f_arr=None,
    dt=None,
    df=None,
    PSD="lisasens",
    PSD_args=(),
    PSD_kwargs=None,
    normalize=False,
):
    """<a|b> = 4 Re sum df a*(f) b(f) / PSD(f), summed over channels.

    Frequency-domain inputs with ``f_arr``; time-domain inputs with ``dt``
    (rFFT'd here). ``PSD`` is a `get_sensitivity` name or a function of the
    frequencies. ``normalize=True`` returns the overlap <a|b>/sqrt(<a|a><b|b>).
    """
    PSD_kwargs = PSD_kwargs or {}
    a = _as_channel_list(sig1)
    b = _as_channel_list(sig2)
    if len(a) != len(b):
        raise ValueError("channel count mismatch")

    if dt is not None:  # TD inputs
        n = len(a[0])
        freqs = np.fft.rfftfreq(n, dt)[1:]
        a = [np.fft.rfft(ch)[1:] * dt for ch in a]
        b = [np.fft.rfft(ch)[1:] * dt for ch in b]
        f_arr = freqs

    if f_arr is None:
        raise ValueError("provide f_arr (FD inputs) or dt (TD inputs)")
    f_arr = np.asarray(f_arr)
    dfv = _df_vector(f_arr) if df is None else np.full(f_arr.shape, df)

    if callable(PSD):
        psd = np.asarray(PSD(f_arr, *PSD_args, **PSD_kwargs))
    else:
        psd = np.asarray(get_sensitivity(f_arr, sens_fn=PSD, **PSD_kwargs))

    out = 0.0
    for ca, cb in zip(a, b):
        out = out + 4.0 * np.sum(dfv * np.real(np.conj(ca) * cb) / psd)
    if normalize:
        if dt is not None:
            raise NotImplementedError("normalize with TD inputs: call with FD arrays")
        kw = dict(f_arr=f_arr, df=df, PSD=PSD, PSD_args=PSD_args, PSD_kwargs=PSD_kwargs)
        naa = inner_product(sig1, sig1, **kw)
        nbb = inner_product(sig2, sig2, **kw)
        return out / np.sqrt(naa * nbb)
    return out


def overlap(sig1, sig2, **kwargs):
    return inner_product(sig1, sig2, normalize=True, **kwargs)


def get_mismatch(sig1, sig2, **kwargs):
    """1 - overlap."""
    return 1.0 - overlap(sig1, sig2, **kwargs)


def snr(sig, data=None, **kwargs):
    """Optimal SNR sqrt(<h|h>), or matched-filter SNR <d|h>/sqrt(<h|h>)."""
    opt = np.sqrt(inner_product(sig, sig, **kwargs))
    if data is None:
        return opt
    return inner_product(data, sig, **kwargs) / opt


def dh_dlambda(waveform_fn, params, i, eps):
    """5-point central-stencil derivative of the waveform with respect to
    ``params[i]``, channel by channel, on the waveform's own device:
    (-h(+2e) + 8 h(+e) - 8 h(-e) + h(-2e)) / (12 e)."""
    params = np.asarray(params, dtype=np.float64)

    def at(delta):
        p = params.copy()
        p[i] += delta
        return _channels(waveform_fn(p))

    h2p, h1p, h1m, h2m = at(2 * eps), at(eps), at(-eps), at(-2 * eps)
    return [
        (-ch2p + 8.0 * ch1p - 8.0 * ch1m + ch2m) / (12.0 * eps)
        for ch2p, ch1p, ch1m, ch2m in zip(h2p, h1p, h1m, h2m)
    ]


def fisher(waveform_fn, params, eps, **ip_kwargs):
    """Fisher matrix Gamma_ij = <dh/di | dh/dj> (``eps`` a scalar or one
    step per parameter), host float64."""
    params = np.asarray(params, dtype=np.float64)
    ndim = len(params)
    eps = np.broadcast_to(np.asarray(eps, dtype=np.float64), (ndim,))
    derivs = [dh_dlambda(waveform_fn, params, i, eps[i]) for i in range(ndim)]
    gamma = np.zeros((ndim, ndim))
    for i in range(ndim):
        for j in range(i, ndim):
            gamma[i, j] = gamma[j, i] = inner_product(derivs[i], derivs[j], **ip_kwargs)
    return gamma


def pinv_highprec(mat, dps: int = 500):
    """Inverse of a symmetric matrix at ``dps`` decimal digits (mpmath).

    EMRI Fisher matrices in physical coordinates can have condition numbers
    past 1e16, where a float64 ``pinv`` drops the small eigenvalues and
    understates the Cramer-Rao widths of the soft directions. The matrix is
    first scaled by its diagonal, D^-1 (D^-1 G D^-1)^-1 D^-1.
    """
    import mpmath as mp

    g = np.asarray(mat, dtype=np.float64)
    d = np.sqrt(np.abs(np.diag(g)))
    d[d == 0.0] = 1.0
    gs = g / np.outer(d, d)
    with mp.workdps(dps):
        minv = mp.matrix(gs.tolist()) ** -1
        inv = np.array(
            [[float(minv[i, j]) for j in range(g.shape[1])] for i in range(g.shape[0])]
        )
    return inv / np.outer(d, d)


def covariance(
    waveform_fn,
    params,
    eps,
    diagonalize: bool = False,
    precision: bool = False,
    dps: int = 500,
    **ip_kwargs,
):
    """Inverse Fisher: the ``dps``-digit `pinv_highprec` with
    ``precision=True``, else float64 ``pinv``; ``diagonalize=True`` also
    returns its (eigenvalues, eigenvectors)."""
    gamma = fisher(waveform_fn, params, eps, **ip_kwargs)
    cov = pinv_highprec(gamma, dps=dps) if precision else np.linalg.pinv(gamma)
    if diagonalize:
        evals, evecs = np.linalg.eigh(cov)
        return cov, (evals, evecs)
    return cov


def mismatch_criterion(waveform_fn, params, cov, n_draws: int = 100, seed: int = 0, **ip_kwargs):
    """1 - overlap of the waveform with itself at ``n_draws`` displacements
    drawn from N(0, cov) (``numpy.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    base = _as_channel_list(waveform_fn(np.asarray(params)))
    out = []
    for _ in range(n_draws):
        dp = rng.multivariate_normal(np.zeros(len(params)), cov)
        pert = _as_channel_list(waveform_fn(np.asarray(params) + dp))
        out.append(1.0 - inner_product(base, pert, normalize=True, **ip_kwargs))
    return np.asarray(out)


def get_eigens(arr, high_precision: bool = False):
    """Symmetric eigen-decomposition (``eigh``) of a Fisher or covariance
    matrix; ``high_precision`` is accepted and ignored, as in the reference."""
    del high_precision
    return np.linalg.eigh(np.asarray(arr, dtype=np.float64))


def vallisneri_criterion(
    waveform_fn,
    params,
    fish=None,
    eps=None,
    eigens=None,
    rng=None,
    **ip_kwargs,
):
    """One draw of Vallisneri's (2008) maximum-mismatch ratio criterion.

    Displaces the parameters to a random point of the Fisher 1-sigma
    contour, ``delta = sum_l x_l v_l / sqrt(w_l)`` with x a unit vector,
    and compares the true overlap with the Fisher prediction:
    ratio = overlap(h(p + delta), h(p)) / (1 - 0.5 delta^T G delta / <h|h>).
    Returns (mismatch, ratio), mismatch = (1 - overlap) / 2.
    """
    params = np.asarray(params, dtype=np.float64)
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    if fish is None:
        if eps is None:
            raise ValueError("supply fish or eps for Fisher generation")
        fish = fisher(waveform_fn, params, eps, **ip_kwargs)
    w, v = eigens if eigens is not None else get_eigens(fish)

    u = rng.standard_normal(len(params))
    x = u / np.linalg.norm(u)
    vec_delta = (v / np.sqrt(np.maximum(w, 1e-300))[None, :]) @ x

    h_true = _as_channel_list(waveform_fn(params))
    h_delta = _as_channel_list(waveform_fn(params + vec_delta))
    over = inner_product(h_delta, h_true, normalize=True, **ip_kwargs)
    prod = float(vec_delta @ fish @ vec_delta)
    norm_true = inner_product(h_true, h_true, **ip_kwargs)
    ratio = over / (1.0 - 0.5 * prod / norm_true)
    return (1.0 - over) / 2.0, ratio


def vallisneri_criterion_cdf(
    waveform_fn,
    params,
    eps=None,
    num_samples: int = 100,
    return_cdf: bool = True,
    return_ratios: bool = False,
    fish=None,
    seed: int = 0,
    **ip_kwargs,
):
    """CDF of |ln ratio| over ``num_samples`` 1-sigma contour draws and its
    90th percentile: ``(r_at_90[, quantiles, cdf][, ratios])``. The Fisher
    approximation is trustworthy where r_at_90 is well below 1."""
    params = np.asarray(params, dtype=np.float64)
    if fish is None:
        if eps is None:
            raise ValueError("supply fish or eps for Fisher generation")
        fish = fisher(waveform_fn, params, eps, **ip_kwargs)
    eigens = get_eigens(fish)
    rng = np.random.default_rng(seed)

    ratios = np.empty(num_samples)
    for j in range(num_samples):
        _, ratio = vallisneri_criterion(
            waveform_fn, params, fish=fish, eigens=eigens, rng=rng, **ip_kwargs
        )
        ratios[j] = abs(np.log(ratio))

    quantiles, counts = np.unique(ratios, return_counts=True)
    cdf = np.cumsum(counts).astype(np.float64) / ratios.size
    r_at_90 = float(np.interp(0.9, cdf, quantiles))

    out = (r_at_90,)
    if return_cdf:
        out += (quantiles, cdf)
    if return_ratios:
        out += (ratios,)
    return out


def cutler_vallisneri_bias(
    waveform_true_fn, waveform_approx_fn, params, eps, return_fisher=False, **ip_kwargs
):
    """Linear waveform-systematics bias
    dtheta_i = (Gamma^-1)_ij <dh/dj | h_true - h_approx>, Gamma the Fisher
    matrix of the approximate waveform."""
    params = np.asarray(params, dtype=np.float64)
    gamma = fisher(waveform_approx_fn, params, eps, **ip_kwargs)
    ndim = len(params)
    eps_v = np.broadcast_to(np.asarray(eps, dtype=np.float64), (ndim,))
    h_true = _as_channel_list(waveform_true_fn(params))
    h_ap = _as_channel_list(waveform_approx_fn(params))
    diff = [a - b for a, b in zip(h_true, h_ap)]
    proj = np.array(
        [
            inner_product(dh_dlambda(waveform_approx_fn, params, i, eps_v[i]), diff, **ip_kwargs)
            for i in range(ndim)
        ]
    )
    bias = np.linalg.pinv(gamma) @ proj
    if return_fisher:
        return bias, gamma
    return bias


def scale_snr(target_snr, sig, **kwargs):
    """Rescale channels to a target optimal SNR: (channels, factor)."""
    current = snr(sig, **kwargs)
    factor = target_snr / current
    return [s * factor for s in _as_channel_list(sig)], factor


__all__ = [
    "inner_product",
    "overlap",
    "get_mismatch",
    "snr",
    "dh_dlambda",
    "fisher",
    "covariance",
    "mismatch_criterion",
    "get_eigens",
    "vallisneri_criterion",
    "vallisneri_criterion_cdf",
    "cutler_vallisneri_bias",
    "scale_snr",
]
