"""Data-driven amplitude backends: grid interpolation and a learned network.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.amplitude_backends``,
with the same interface as `models.amplitude.mode_amplitudes`:

* `Interp2DAmplitude`: Catmull-Rom bicubic interpolation over a regular
  grid in the separatrix-adapted coordinates ``(u, e)``,
  ``u = log(p - 6 - 2e + 0.5)``. `build_amplitude_grid` tabulates any
  ``source(p, e, table)`` (``source=models.amplitude.full_fidelity_amplitudes``
  for the highest physics rung) on the reference's ``np.linspace`` grid, in
  the same ``(nu, ne, n_modes, 2)`` layout, on a ``device``.
* `RomanAmplitude`: a small MLP ``(u, e) -> A_lmn`` as a `torch.nn.Module`
  with float64 weights; `roman_forward` is its functional form and
  `fit_roman_network` trains it against any amplitude source with
  `torch.optim.Adam` (optax ``adam``'s defaults), on the reference's numpy
  draws. The products are float64 ``@``, so TF32 never enters them.

Weights and grids of the JAX package carry over through
`convert.amplitude_grid_from_numpy` and `convert.roman_params_from_numpy`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp2d import interp2d_bicubic
from ..utils.device import resolve_device
from .amplitude import ModeTable, default_mode_table, mode_amplitudes
from .geodesic import separatrix

_U_SHIFT = 0.5
_F64 = torch.float64


def u_of_pe(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return torch.log(p - separatrix(e) + _U_SHIFT)


def _p_of_ue(u: np.ndarray, e: np.ndarray) -> np.ndarray:
    return np.exp(u) - _U_SHIFT + 6.0 + 2.0 * e


class AmplitudeGrid(NamedTuple):
    """Regular (u, e) amplitude table for a static mode inventory."""

    u0: float
    du: float
    e0: float
    de: float
    values: torch.Tensor  # (nu, ne, n_modes, 2) re/im
    table: ModeTable


def build_amplitude_grid(
    table: ModeTable | None = None,
    *,
    u_range=(np.log(_U_SHIFT + 0.05), np.log(16.0)),
    e_range=(1e-6, 0.75),
    n_u: int = 64,
    n_e: int = 33,
    source=mode_amplitudes,
    device=None,
) -> AmplitudeGrid:
    """Tabulate ``source(p, e, table)`` on a regular (u, e) grid, evaluated on
    ``device`` (default the current CUDA device; ``"cpu"`` on the CPU)."""
    dev = resolve_device(device)
    table = table or default_mode_table()
    us = np.linspace(u_range[0], u_range[1], n_u)
    es = np.linspace(e_range[0], e_range[1], n_e)
    uu, ee = np.meshgrid(us, es, indexing="ij")
    pp = _p_of_ue(uu, ee)
    re, im = source(torch.as_tensor(pp.ravel(), dtype=_F64, device=dev),
                    torch.as_tensor(ee.ravel(), dtype=_F64, device=dev), table)
    vals = torch.stack([re, im], dim=-1).reshape(n_u, n_e, table.num_modes, 2)
    return AmplitudeGrid(
        u0=float(us[0]), du=float(us[1] - us[0]), e0=float(es[0]), de=float(es[1] - es[0]),
        values=vals, table=table,
    )


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def mode_amplitudes_interp2d(p, e, grid: AmplitudeGrid):
    """Grid-backend evaluation matching `mode_amplitudes`' signature:
    (re, im), each ``broadcast(p, e).shape + (n_modes,)``, on the grid's
    device."""
    p, e = _on(p, grid.values), _on(e, grid.values)
    out = interp2d_bicubic(grid.u0, grid.du, grid.e0, grid.de, grid.values, u_of_pe(p, e), e)
    return out[..., 0], out[..., 1]


def _mode_dict(re: torch.Tensor, im: torch.Tensor, table: ModeTable, specific_modes):
    """{(l, m, n): complex numpy array}; m < 0 requests are served from the
    stored (l, -m, -n) mode as (-1)^l conj(A)."""
    re = re.detach().cpu().numpy()
    im = im.detach().cpu().numpy()
    lookup = {
        (int(l), int(m), int(n)): i
        for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
    }
    out = {}
    for lmn in specific_modes or list(lookup):
        l, m, n = lmn
        if m < 0:
            i = lookup[(l, -m, -n)]
            out[lmn] = ((-1.0) ** l) * np.conj(re[..., i] + 1j * im[..., i])
        else:
            i = lookup[lmn]
            out[lmn] = re[..., i] + 1j * im[..., i]
    return out


class Interp2DAmplitude:
    """The reference's interpolated-amplitude call contract:
    ``amp(p, e, specific_modes=[(l, m, n), ...]) -> {(l, m, n): complex
    numpy array}``. Without a ``grid`` it builds the default one on
    ``device``."""

    def __init__(self, grid: AmplitudeGrid | None = None, device=None, **kwargs):
        del kwargs  # the reference's max_init_len / use_gpu
        self.grid = grid or build_amplitude_grid(device=device)

    def __call__(self, p, e, specific_modes=None):
        re, im = mode_amplitudes_interp2d(p, e, self.grid)
        return _mode_dict(re, im, self.grid.table, specific_modes)


class RomanParams(NamedTuple):
    weights: tuple
    biases: tuple
    table: ModeTable
    scale: torch.Tensor  # per-mode output scaling (re, im)


def init_roman_network(
    table: ModeTable | None = None, hidden=(64, 64, 64), seed: int = 0, device=None
) -> RomanParams:
    """He-normal weights from ``numpy.random.default_rng(seed)``, layer by
    layer (the reference's draws, bit for bit), zero biases, unit scale, all
    float64 on ``device`` (default the current CUDA device)."""
    dev = resolve_device(device)
    table = table or default_mode_table()
    sizes = (2,) + tuple(hidden) + (2 * table.num_modes,)
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for a, b in zip(sizes[:-1], sizes[1:]):
        ws.append(torch.as_tensor(rng.normal(0, np.sqrt(2.0 / a), (a, b)), dtype=_F64, device=dev))
        bs.append(torch.zeros((b,), dtype=_F64, device=dev))
    return RomanParams(tuple(ws), tuple(bs), table,
                       torch.ones((2 * table.num_modes,), dtype=_F64, device=dev))


def roman_forward(params: RomanParams, p, e):
    """MLP amplitudes -> (re, im), each (..., n_modes), on the weights'
    device in their dtype."""
    w0 = params.weights[0]
    p, e = _on(p, w0), _on(e, w0)
    x = torch.stack([u_of_pe(p, e), e], dim=-1)
    for w, b in zip(params.weights[:-1], params.biases[:-1]):
        x = torch.tanh(x @ w + b)
    x = (x @ params.weights[-1] + params.biases[-1]) * params.scale
    n = params.table.num_modes
    return x[..., :n], x[..., n:]


def fit_roman_network(
    params: RomanParams,
    *,
    n_steps: int = 2000,
    batch: int = 512,
    lr: float = 3e-3,
    seed: int = 1,
    u_range=(np.log(_U_SHIFT + 0.05), np.log(12.0)),
    e_range=(1e-4, 0.7),
    source=mode_amplitudes,
    verbose: bool = False,
) -> RomanParams:
    """Train the network against an amplitude source, on the weights' device.

    As the reference: the output scale is each mode's largest |re| and |im|
    over 2048 probe orbits (floored at 1e-12), the loss the mean squared
    scaled error, Adam with b1 0.9, b2 0.999, eps 1e-8; the numpy draws come
    in the reference's order (the probes' u then e, then one (u, e) batch
    per step), so both fits see the same orbits.
    """
    table = params.table
    w0 = params.weights[0]
    rng = np.random.default_rng(seed)

    def orbits(n):
        u = rng.uniform(*u_range, n)
        e = rng.uniform(*e_range, n)
        return _on(_p_of_ue(u, e), w0), _on(e, w0)

    re, im = source(*orbits(2048), table)
    mag = torch.clamp_min(torch.cat([re.abs().amax(0), im.abs().amax(0)]).to(w0.dtype), 1e-12)
    params = params._replace(scale=mag)
    n = table.num_modes

    ws = [w.detach().clone().requires_grad_(True) for w in params.weights]
    bs = [b.detach().clone().requires_grad_(True) for b in params.biases]
    opt = torch.optim.Adam(ws + bs, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for i in range(n_steps):
        pb, eb = orbits(batch)
        tr, ti = (t.to(w0.dtype) for t in source(pb, eb, table))
        mre, mim = roman_forward(params._replace(weights=tuple(ws), biases=tuple(bs)), pb, eb)
        loss = torch.mean(((mre - tr) / mag[:n]) ** 2 + ((mim - ti) / mag[n:]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if verbose and i % 200 == 0:
            print(f"roman fit step {i}: loss {float(loss):.3e}")
    return params._replace(weights=tuple(w.detach() for w in ws),
                           biases=tuple(b.detach() for b in bs))


class RomanAmplitude(torch.nn.Module):
    """The reference's ROMAN-net call contract as a module: its weights and
    biases are float64 `Parameter`s, its output scale a buffer;
    ``amp(p, e, specific_modes=...)`` returns ``{(l, m, n): complex numpy
    array}``. Without ``params`` it starts from `init_roman_network` on
    ``device``."""

    def __init__(self, params: RomanParams | None = None, device=None, **kwargs):
        del kwargs  # the reference's max_init_len / use_gpu
        super().__init__()
        params = params or init_roman_network(device=device)
        self.table = params.table
        self.weights = torch.nn.ParameterList(
            [torch.nn.Parameter(w.detach().to(_F64)) for w in params.weights])
        self.biases = torch.nn.ParameterList(
            [torch.nn.Parameter(b.detach().to(_F64)) for b in params.biases])
        self.register_buffer("scale", params.scale.detach().to(_F64))

    @property
    def params(self) -> RomanParams:
        return RomanParams(tuple(self.weights), tuple(self.biases), self.table, self.scale)

    def forward(self, p, e, specific_modes=None):
        with torch.no_grad():
            re, im = roman_forward(self.params, p, e)
        return _mode_dict(re, im, self.table, specific_modes)


__all__ = [
    "u_of_pe",
    "AmplitudeGrid",
    "build_amplitude_grid",
    "mode_amplitudes_interp2d",
    "Interp2DAmplitude",
    "RomanParams",
    "init_roman_network",
    "roman_forward",
    "fit_roman_network",
    "RomanAmplitude",
]
