"""Where the port's entry points run (no JAX needed).

`resolve_device` picks an explicit device, else the first tensor's device,
else the current CUDA device; with no CUDA device and nothing named it
raises instead of running on the CPU. The entry points that take Python
scalars (the trajectory, the prologue, `FrozenFDWaveform`, the numpy
converters) go through it; named ``device="cpu"`` they run on the CPU.
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import flux as t_flux
from emri_frequencydomainwaveforms_tpu_torch.models import geodesic as t_geo
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch.ops import bessel as t_bes
from emri_frequencydomainwaveforms_tpu_torch.ops.cubic_spline import CubicSplineInterpolant
from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "meta", "cuda:1"])
def test_explicit_device_wins(device):
    x = torch.zeros(2)
    assert resolve_device(device, 1.0, x) == torch.device(device)


def test_first_tensor_device():
    assert resolve_device(None, 1.0, np.ones(2), torch.zeros(2, device="meta"), torch.zeros(2)) == (
        torch.device("meta")
    )
    assert resolve_device(None, torch.zeros(2)) == torch.device("cpu")


def test_cuda_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device(None, 1.0, 2.0) == torch.device("cuda", 3)
    assert resolve_device() == torch.device("cuda", 3)


def test_no_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None, 1.0, np.ones(3))


def _frozen(**kw):
    table = default_mode_table(8, l_max=2)
    return t_wf.FrozenFDWaveform(
        table, np.zeros(table.num_modes, np.int32), f0=1e-4, df=1e-7, nf=1000, t_years=0.01, **kw
    )


_SCALAR_CALLS = {
    "schwarz_ecc_flux_inspiral": lambda **kw: t_insp.schwarz_ecc_flux_inspiral(
        1e6, 10.0, 12.0, 0.35, t_years=0.01, max_steps=32, **kw),
    "get_p_at_t": lambda **kw: t_insp.get_p_at_t(1e6, 10.0, 0.3, 0.01, n_iters=2, max_steps=32, **kw),
    "waveform_prologue": lambda **kw: t_wf.waveform_prologue(
        1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0, t_years=0.01,
        table=default_mode_table(8, l_max=2), k_max=4, eps=1e-2, max_steps=32, **kw),
    "FrozenFDWaveform": _frozen,
    "get_mu_at_t": lambda **kw: t_insp.get_mu_at_t(1e6, 9.0, 0.3, 0.01, n_iters=2, max_steps=32, **kw),
    "build_flux_grid": lambda **kw: t_flux.build_flux_grid(n_u=4, n_e=4, tail=True, **kw).values,
    "flux_grid_from_numpy": lambda **kw: convert.flux_grid_from_numpy(
        0.0, 0.1, 0.0, 0.1, np.zeros((4, 4, 2)), **kw).values,
    "schwarz_ecc_flux_inspiral quad": lambda **kw: t_insp.schwarz_ecc_flux_inspiral(
        1e6, 10.0, 12.0, 0.35, t_years=0.01, max_steps=32, method="quad", **kw),
    "EMRIInspiral": lambda **kw: t_insp.EMRIInspiral(max_steps=32, **kw)(
        1e6, 10.0, 0.0, 12.0, 0.35, 1.0, T=0.01),
    "fundamental_frequencies_kerr_generic": lambda **kw: t_geo.fundamental_frequencies_kerr_generic(
        0.5, 9.0, 0.3, 0.7, **kw),
    "CubicSplineInterpolant": lambda **kw: CubicSplineInterpolant(
        np.linspace(0.0, 1.0, 6), np.arange(6.0), **kw)(np.array([0.25, 0.5])),
    "kve_one_third": lambda **kw: t_bes.kve_one_third(np.array([0.5 + 0.5j, 9.0]), **kw),
    "bessel_jn": lambda **kw: t_bes.bessel_jn(4, np.array([0.0, 1.5]), **kw),
}


@pytest.mark.parametrize("name", sorted(_SCALAR_CALLS))
def test_scalar_entry_points_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _SCALAR_CALLS[name]()


@pytest.mark.parametrize("fn", [convert.prologue_from_numpy, convert.fd_inputs_from_numpy])
def test_converters_raise_without_cuda(no_cuda, fn):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn({})


@pytest.mark.parametrize("name", sorted(_SCALAR_CALLS))
def test_scalar_entry_points_run_on_named_cpu(no_cuda, name):
    res = _SCALAR_CALLS[name](device="cpu")
    if isinstance(res, torch.nn.Module):
        tensors = list(res.buffers())
    elif isinstance(res, torch.Tensor):
        tensors = [res]
    else:
        tensors = [x for x in res if isinstance(x, torch.Tensor)]
    assert tensors and all(t.device == torch.device("cpu") for t in tensors)
