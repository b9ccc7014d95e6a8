"""Parameter transforms: sampled space -> waveform space.

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.transform``
(`TransformContainer`): index-keyed transforms applied after the fixed
parameters are filled in at their full-dimensional positions. Works on
float64 tensors (numpy arrays are converted), batched over leading axes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


class TransformContainer:
    """Fill fixed parameter slots, then apply index-keyed transforms.

    Args:
      parameter_transforms: mapping from an int or a tuple of ints (indices
        into the full layout, after filling) to a callable. Scalar-key
        callables map value -> value; tuple-key callables map
        (v_i, v_j, ...) -> a sequence of the same length.
      fill_dict: {"ndim_full": N, "fill_values": array, "fill_inds": array}
        or None for no filling.
    """

    def __init__(self, parameter_transforms: Mapping | None = None,
                 fill_dict: Mapping | None = None):
        self.parameter_transforms = dict(parameter_transforms or {})
        if fill_dict is not None:
            self.ndim_full = int(fill_dict["ndim_full"])
            self.fill_inds = np.asarray(fill_dict["fill_inds"], dtype=np.int64)
            self.fill_values = np.asarray(fill_dict["fill_values"], dtype=np.float64)
            self.test_inds = np.setdiff1d(np.arange(self.ndim_full), self.fill_inds)
        else:
            self.ndim_full = None
            self.fill_inds = None
            self.fill_values = None
            self.test_inds = None

    def fill_values_func(self, params):
        """Insert the fixed values -> (..., ndim_full)."""
        params = torch.as_tensor(params, dtype=torch.float64)
        if self.fill_inds is None:
            return params
        dev = params.device
        out = torch.zeros(params.shape[:-1] + (self.ndim_full,), dtype=params.dtype, device=dev)
        out[..., torch.as_tensor(self.test_inds, device=dev)] = params
        out[..., torch.as_tensor(self.fill_inds, device=dev)] = torch.as_tensor(
            self.fill_values, dtype=params.dtype, device=dev)
        return out

    def transform_base_parameters(self, params_full):
        """Apply the transforms in key order on the full layout."""
        out = torch.as_tensor(params_full, dtype=torch.float64).clone()
        for key, fn in self.parameter_transforms.items():
            if isinstance(key, tuple):
                vals = fn(*[out[..., k].clone() for k in key])
                for k, v in zip(key, vals):
                    out[..., k] = v
            else:
                out[..., key] = fn(out[..., key].clone())
        return out

    def both_transforms(self, params, return_transpose: bool = False):
        """Fill, then transform: (..., ndim_sampled) -> (..., ndim_full)."""
        out = self.transform_base_parameters(self.fill_values_func(params))
        return out.T if return_transpose else out

    def __call__(self, params):
        return self.both_transforms(params)


__all__ = ["TransformContainer"]
