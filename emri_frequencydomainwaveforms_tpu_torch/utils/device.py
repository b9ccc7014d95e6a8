"""Which device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None, *values) -> torch.device:
    """The device for a call: ``device`` when given, else the device of the
    first tensor among ``values`` (other values are skipped), else the
    current CUDA device.

    There is no quiet CPU fallback: with no device named, no tensor given and
    no CUDA device, it raises and asks for ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    for x in values:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or CPU tensors) to run the port on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


__all__ = ["resolve_device"]
