"""The reference's utility functions, with its call signatures.

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.utility``:
``get_fundamental_frequencies(a, p, e, x)``, ``get_separatrix(a, e, x)``,
``get_overlap`` / ``get_mismatch``, the list-style ``get_p_at_t`` /
``get_mu_at_t``, the ``SchwarzschildEccentric.sanity_check_init`` domain
guard and ``cuda_set_device``. The geodesic functions return numpy; each
takes a ``device`` keyword (default a tensor argument's device, else the
current CUDA device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import geodesic
from . import inspiral as _inspiral


def _host(*xs):
    return tuple(x.cpu().numpy() for x in xs)


def _np(v):
    """A routing argument on the host."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def get_fundamental_frequencies(a, p, e, x, *, device=None):
    """(OmegaPhi, OmegaTheta, OmegaR) for generic (a, p, e, x = cos I).

    a = 0 with |x| = 1 takes the Schwarzschild quadrature, |x| = 1 the
    equatorial Kerr solve (`geodesic.fundamental_frequencies_kerr`), any
    other inclination the generic one
    (`geodesic.fundamental_frequencies_kerr_generic`).
    """
    dev = resolve_device(device, a, p, e, x)
    p, e = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (p, e))
    if np.all(_np(a) == 0.0) and np.all(np.abs(_np(x)) == 1.0):
        om_phi, om_r = _host(*geodesic.fundamental_frequencies(p, e))
        sign = np.sign(_np(x).astype(np.float64))
        om_phi = om_phi * np.where(sign == 0, 1.0, sign)
        return om_phi, np.abs(om_phi), om_r
    equatorial = np.all(np.abs(_np(x)) == 1.0)
    a, x = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (a, x))
    if equatorial:
        return _host(*geodesic.fundamental_frequencies_kerr(a, p, e, x))
    return _host(*geodesic.fundamental_frequencies_kerr_generic(a, p, e, x))


def get_separatrix(a, e, x, *, device=None):
    """Separatrix p_s(a, e, x): 6 + 2e at a = 0, the equatorial Kerr
    bisection at |x| = 1, the generic-inclination bisection otherwise."""
    dev = resolve_device(device, a, e, x)
    e = torch.as_tensor(e, dtype=torch.float64, device=dev)
    if np.all(_np(a) == 0.0):
        return geodesic.separatrix(e).cpu().numpy()
    equatorial = np.all(np.abs(_np(x)) == 1.0)
    a, x = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (a, x))
    if equatorial:
        return geodesic.separatrix_kerr(a, e, x).cpu().numpy()
    return geodesic.separatrix_kerr_generic(a, e, x).cpu().numpy()


def get_overlap(time_series_1, time_series_2, use_gpu=False):
    """Plain (unweighted) normalized overlap of two complex series."""
    a = np.asarray(time_series_1).ravel()
    b = np.asarray(time_series_2).ravel()
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    num = np.real(np.vdot(a, b))
    den = np.sqrt(np.real(np.vdot(a, a)) * np.real(np.vdot(b, b)))
    return num / den


def get_mismatch(time_series_1, time_series_2, use_gpu=False):
    return 1.0 - get_overlap(time_series_1, time_series_2)


def get_p_at_t(traj_module, t_out, traj_args, *, bounds=None, device=None, **kwargs):
    """The reference's signature: ``traj_args = [M, mu, a, e0, x0]``."""
    m, mu = traj_args[0], traj_args[1]
    e0 = traj_args[3] if len(traj_args) > 3 else traj_args[-1]
    kw = {} if bounds is None else {"p_lo": bounds[0], "p_hi": bounds[1]}
    return float(_inspiral.get_p_at_t(m, mu, e0, t_out, device=device, **kw)[0])


def get_mu_at_t(traj_module, t_out, traj_args, *, device=None, **kwargs):
    """``traj_args = [M, a, p0, e0, x0]`` (the reference's ordering)."""
    m, p0, e0 = traj_args[0], traj_args[2], traj_args[3]
    return float(_inspiral.get_mu_at_t(m, p0, e0, t_out, device=device)[0])


def cuda_set_device(dev):
    """Make CUDA device ``dev`` the current one (`torch.cuda.set_device`):
    the port's entry points run there unless told otherwise."""
    torch.cuda.set_device(dev)


class SchwarzschildEccentric:
    """The reference's domain guard (``sanity_check_init``)."""

    p_min_offset = 0.1
    e_max = 0.75

    def __init__(self, use_gpu=False):
        del use_gpu

    def sanity_check_init(self, M, mu, p0, e0):
        if not (M > 0 and mu > 0):
            raise ValueError("masses must be positive")
        if mu / M > 1e-3:
            raise ValueError(f"mass ratio {mu / M:.2e} outside the EMRI regime")
        if e0 < 0 or e0 > self.e_max:
            raise ValueError(f"e0 = {e0} outside [0, {self.e_max}]")
        p_sep = 6.0 + 2.0 * e0
        if p0 < p_sep + self.p_min_offset:
            raise ValueError(f"p0 = {p0} too close to the separatrix {p_sep}")
        return True

    def sanity_check_angles(self, qS, phiS, qK, phiK):
        for name, v in (("qS", qS), ("qK", qK)):
            if not (0 <= v <= np.pi):
                raise ValueError(f"{name} outside [0, pi]")
        return True


__all__ = [
    "get_fundamental_frequencies",
    "get_separatrix",
    "get_overlap",
    "get_mismatch",
    "get_p_at_t",
    "get_mu_at_t",
    "cuda_set_device",
    "SchwarzschildEccentric",
]
