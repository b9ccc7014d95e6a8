"""Carry pipeline state from numpy into the port's batched tensors.

The parity tests drive each stage of the port from the JAX package's own
inputs; the JAX side hands its NamedTuples over as numpy arrays (this module
never imports JAX). A state without a walker axis (``t_knots`` 1-D, as the
reference produces for one source) gets a leading batch axis of 1.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.amplitude import ModeTable
from .models.amplitude_backends import AmplitudeGrid, RomanParams
from .models.flux import FluxGrid
from .models.modeselect import SelectedModes
from .models.summation_fd import FDKernelInputs
from .models.waveform import WaveformPrologue
from .utils.device import resolve_device

_INT_DTYPES = {"n_live": torch.int32, "idx": torch.int64}


def _tensor(x, device, name: str = "", add_batch: bool = False) -> torch.Tensor:
    a = np.array(x)  # a writable copy
    if np.issubdtype(a.dtype, np.integer) or np.issubdtype(a.dtype, np.bool_):
        dtype = _INT_DTYPES.get(name, torch.int32)
    else:
        dtype = torch.float32 if a.dtype == np.float32 else torch.float64
    t = torch.as_tensor(a, device=device).to(dtype)
    return t[None] if add_batch else t


def _fields(x) -> dict:
    """A namedtuple's or a mapping's fields as a dict."""
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def mode_table_from_numpy(ls, ms, ns) -> ModeTable:
    """A port ModeTable from (l, m, n) integer arrays."""
    return ModeTable(np.asarray(ls), np.asarray(ms), np.asarray(ns))


def prologue_from_numpy(fields, device=None) -> WaveformPrologue:
    """WaveformPrologue from a namedtuple (or mapping) of numpy arrays with
    the reference's field names; ``sel`` is a (idx, mask, power) triple and
    ``y_plus`` / ``y_minus`` (re, im) pairs. ``device`` defaults to the
    current CUDA device (raises without one: pass ``device="cpu"``)."""
    device = resolve_device(device)
    f = _fields(fields)
    add = np.ndim(f["t_knots"]) == 1

    def t(name, x=None):
        return _tensor(f[name] if x is None else x, device, name, add)

    sel = f["sel"]
    return WaveformPrologue(
        t_knots=t("t_knots"),
        n_live=t("n_live"),
        phi_phi=t("phi_phi"),
        phi_r=t("phi_r"),
        a_re=t("a_re"),
        a_im=t("a_im"),
        sel=SelectedModes(
            idx=_tensor(sel[0], device, "idx", add),
            mask=_tensor(sel[1], device, "mask", add),
            power=_tensor(sel[2], device, "power", add),
        ),
        y_plus=(t("y_plus", f["y_plus"][0]), t("y_plus", f["y_plus"][1])),
        y_minus=(t("y_minus", f["y_minus"][0]), t("y_minus", f["y_minus"][1])),
        t_end=t("t_end"),
        dist_factor=t("dist_factor"),
    )


def fd_inputs_from_numpy(fields, device=None) -> FDKernelInputs:
    """FDKernelInputs from a namedtuple (or mapping) of numpy arrays with the
    reference's field names; ``device`` as for `prologue_from_numpy`."""
    device = resolve_device(device)
    f = _fields(fields)
    add = np.ndim(f["t_knots"]) == 1
    return FDKernelInputs(**{k: _tensor(f[k], device, k, add) for k in FDKernelInputs._fields})


def flux_grid_from_numpy(u0, du, e0, de, values, device=None) -> FluxGrid:
    """A port `FluxGrid` from the fields of the reference's (spacings as
    Python floats, ``values`` (nu, ne, 2) float64 numpy); ``device`` as for
    `prologue_from_numpy`. Trajectories integrated over the same grid agree
    to integrator rounding, which two independently built grids (float32
    amplitude projections summed in different orders) cannot."""
    device = resolve_device(device)
    vals = torch.as_tensor(np.array(values, dtype=np.float64), device=device)
    return FluxGrid(float(u0), float(du), float(e0), float(de), vals)


def _mode_table(table) -> ModeTable:
    if isinstance(table, (tuple, list)):
        return mode_table_from_numpy(*table)
    return mode_table_from_numpy(table.ls, table.ms, table.ns)


def amplitude_grid_from_numpy(fields, device=None) -> AmplitudeGrid:
    """A port `AmplitudeGrid` from the reference's (a namedtuple or mapping:
    spacings as Python floats, ``values`` (nu, ne, n_modes, 2) numpy,
    ``table`` a mode table or an (ls, ms, ns) triple); ``device`` as for
    `prologue_from_numpy`."""
    device = resolve_device(device)
    f = _fields(fields)
    vals = torch.as_tensor(np.array(f["values"], dtype=np.float64), device=device)
    return AmplitudeGrid(float(f["u0"]), float(f["du"]), float(f["e0"]), float(f["de"]), vals,
                         _mode_table(f["table"]))


def roman_params_from_numpy(fields, device=None) -> RomanParams:
    """Port `RomanParams` (float64) from the reference's (``weights`` and
    ``biases`` sequences of numpy arrays, ``table``, ``scale``); ``device``
    as for `prologue_from_numpy`."""
    device = resolve_device(device)
    f = _fields(fields)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), device=device)

    return RomanParams(tuple(t(w) for w in f["weights"]), tuple(t(b) for b in f["biases"]),
                       _mode_table(f["table"]), t(f["scale"]))


__all__ = [
    "amplitude_grid_from_numpy",
    "roman_params_from_numpy",
    "mode_table_from_numpy",
    "prologue_from_numpy",
    "fd_inputs_from_numpy",
    "flux_grid_from_numpy",
]
