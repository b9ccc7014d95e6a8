"""TDI triple-observable container with channel algebra and likelihoods.

Counterpart of ``emri_frequencydomainwaveforms_tpu.lisa.tdi.TDIf``: a
frequency-domain TDI (X, Y, Z) / (A, E, T) triple with elementwise algebra
(+, -, *, / between triples, and with numbers or real arrays), the channel
PSDs, and the noise-weighted reductions ``normsq`` / ``dotprod`` /
``cprod`` / ``logL``.

Both bases are built up front (A, E, T from X, Y, Z or the reverse). The
channels are complex128 tensors on one device (the reference keeps (re, im)
float pairs only because the TPU has no complex128), broadcast to one
shape. The PSDs are computed by `lisa.sensitivity` in float64 on that
device, from the frequency tensor (IEEE float64 represents LISA's ~1e-40
PSDs on the GPU; the reference computes them on the host because the TPU's
emulated float64 flushes them to zero). Arithmetic with a number is complex
arithmetic: ``tdi + 2.0`` adds 2 to the real part of each channel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.device import resolve_device
from .sensitivity import noisepsd_AE, noisepsd_T, noisepsd_X, noisepsd_XY

_SQ2, _SQ3, _SQ6 = math.sqrt(2.0), math.sqrt(3.0), math.sqrt(6.0)
_NAMES = ("X", "Y", "Z", "A", "E", "T")


def _channel(x, device):
    """A complex number array, a real one or a (re, im) pair as a complex128
    tensor on ``device``."""
    if isinstance(x, tuple):
        re, im = (torch.as_tensor(v, dtype=torch.float64, device=device) for v in x)
        return torch.complex(re, im)
    return torch.as_tensor(x, device=device).to(torch.complex128)


@dataclass(frozen=True)
class TDIf:
    """Frequency-domain TDI triple: frequencies ``f`` (Nf,) float64 and the
    six channels, complex128, all on one device."""

    f: torch.Tensor
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    A: torch.Tensor
    E: torch.Tensor
    T: torch.Tensor

    # ---- constructors ----
    @classmethod
    def _build(cls, f, a, b, c, device):
        dev = resolve_device(device, f, a, b, c)
        f = torch.as_tensor(f, dtype=torch.float64, device=dev)
        return f, torch.broadcast_tensors(*(_channel(x, dev) for x in (a, b, c)))

    @classmethod
    def from_xyz(cls, f, X, Y, Z, device=None):
        """From the X, Y, Z channels (complex arrays, tensors or (re, im)
        pairs) on ``device``, else the first tensor's device, else the
        current CUDA device."""
        f, (X, Y, Z) = cls._build(f, X, Y, Z, device)
        A = (Z - X) / _SQ2
        E = (X - 2.0 * Y + Z) / _SQ6
        T = (X + Y + Z) / _SQ3
        return cls(f, X, Y, Z, A, E, T)

    @classmethod
    def from_aet(cls, f, A, E, T, device=None):
        """From the A, E, T channels; the device as in `from_xyz`."""
        f, (A, E, T) = cls._build(f, A, E, T, device)
        # inverse of the orthogonal AET map
        X = -A / _SQ2 + E / _SQ6 + T / _SQ3
        Y = -2.0 * E / _SQ6 + T / _SQ3
        Z = A / _SQ2 + E / _SQ6 + T / _SQ3
        return cls(f, X, Y, Z, A, E, T)

    # ---- host accessors (numpy) ----
    @property
    def Xf(self):
        return self.X.cpu().numpy()

    @property
    def Af(self):
        return self.A.cpu().numpy()

    @property
    def Ef(self):
        return self.E.cpu().numpy()

    @property
    def Tf(self):
        return self.T.cpu().numpy()

    @property
    def df(self):
        if self.f.shape[0] > 1:
            return self.f[1] - self.f[0]
        return torch.ones((), dtype=self.f.dtype, device=self.f.device)

    def __len__(self):
        return self.f.shape[0]

    # ---- channel PSDs, on the channels' device ----
    @property
    def Sae(self):
        return noisepsd_AE(self.f)

    @property
    def St(self):
        return noisepsd_T(self.f)

    @property
    def Sx(self):
        return noisepsd_X(self.f)

    @property
    def Sxy(self):
        return noisepsd_XY(self.f)

    # ---- elementwise algebra ----
    def _zip(self, other, op):
        if isinstance(other, TDIf):
            chans = {n: op(getattr(self, n), getattr(other, n)) for n in _NAMES}
        else:
            s = torch.as_tensor(other, device=self.f.device)
            chans = {n: op(getattr(self, n), s) for n in _NAMES}
        return TDIf(self.f, **chans)

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._zip(other, lambda a, b: a / b)

    # ---- noise-weighted reductions ----
    def normsq(self, noisepsd=None, extranoise=(0.0, 0.0, 0.0)):
        """4 df sum |A|^2 / S_AE + |E|^2 / S_AE + |T|^2 / S_T."""
        if noisepsd is None:
            sae, st = self.Sae, self.St
            sa, se, st = sae + extranoise[0], sae + extranoise[1], st + extranoise[2]
        else:
            sa, se, st = (torch.as_tensor(p, device=self.f.device) for p in noisepsd)
        out = (torch.sum(_abs2(self.A) / sa) + torch.sum(_abs2(self.E) / se)
               + torch.sum(_abs2(self.T) / st))
        return 4.0 * self.df * out

    def normsqx(self, noisepsd=None):
        sx = self.Sx if noisepsd is None else torch.as_tensor(noisepsd, device=self.f.device)
        return 4.0 * self.df * torch.sum(_abs2(self.X) / sx)

    def cprod(self, other: "TDIf"):
        """Complex noise-weighted inner product sum conj(a) b / S over (A, E,
        T), returned as (re, im)."""
        sa, st = self.Sae, self.St
        re = im = 0.0
        for name, s in (("A", sa), ("E", sa), ("T", st)):
            p = getattr(self, name).conj() * getattr(other, name)
            re = re + torch.sum(p.real / s)
            im = im + torch.sum(p.imag / s)
        return 4.0 * self.df * re, 4.0 * self.df * im

    def dotprod(self, other: "TDIf"):
        return self.cprod(other)[0]

    def dotprodx(self, other: "TDIf"):
        return 4.0 * self.df * torch.sum((self.X.conj() * other.X).real / self.Sx)

    def logL(self, other: "TDIf"):
        """-1/2 <d - h, d - h> over (A, E, T)."""
        return -0.5 * (self - other).normsq()


def _abs2(x):
    return x.real**2 + x.imag**2


__all__ = ["TDIf"]
