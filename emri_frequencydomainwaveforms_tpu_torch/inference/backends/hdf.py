"""HDF5 chain backend with resume.

Counterpart of ``emri_frequencydomainwaveforms_tpu.inference.backends.hdf``
(`HDFBackend`, `TempHDFBackend`), with the same file layout: a group
(default "mcmc") with attributes nwalkers, ndim, ntemps, branch_names,
ndims, nleaves_max and iteration, growable datasets ``chain_<branch>``
(nsteps, ntemps, nwalkers, nleaves_max, ndim), ``inds_<branch>``,
``log_like``, ``log_prior`` (nsteps, ntemps, nwalkers) and ``betas``
(nsteps, ntemps), the running sums ``accepted`` (ntemps, nwalkers) and
``swaps_accepted`` (ntemps - 1,), a ``random_state`` of two uint32 words and
an ``info`` group. A chain file written by either package is read by the
other.

The random state cannot carry over between the packages: the reference
stores the words of a JAX PRNG key, this package the seed of its next
iteration's ``torch.Generator``, as (high, low) 32-bit words. A resume reads
the two words as that seed either way: from a file this package wrote, the
resumed chain continues exactly as an uninterrupted one; from a file the
JAX package wrote, it continues from the stored walkers, log-likelihoods
and ladder with a new random stream fixed by the key's words.

h5py is imported inside the functions that use it.
"""

from __future__ import annotations

import os

import numpy as np

from ..state import State
from .memory import Backend, _np


def _seed_words(seed: int) -> np.ndarray:
    """A seed below 2^64 as (high, low) uint32 words."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _seed_of_words(words) -> int:
    """The seed two stored uint32 words hold."""
    w = np.asarray(words, dtype=np.uint64)
    return (int(w[0]) << 32) | int(w[1])


class HDFBackend(Backend):
    """Every iteration lands in ``filename``, so a killed run resumes from it."""

    def __init__(self, filename: str, name: str = "mcmc", dtype=np.float64):
        super().__init__(dtype=dtype)
        self.filename = filename
        self.group = name
        self.initialized = self._probe()

    def _probe(self) -> bool:
        import h5py

        if not os.path.exists(self.filename):
            return False
        with h5py.File(self.filename, "r") as f:
            if self.group not in f:
                return False
            g = f[self.group]
            self.nwalkers = int(g.attrs["nwalkers"])
            self.ntemps = int(g.attrs["ntemps"])
            self.branch_names = [str(b) for b in g.attrs["branch_names"]]
            self.ndims = {k: int(v) for k, v in zip(self.branch_names, g.attrs["ndims"])}
            self.nleaves_max = {
                k: int(v) for k, v in zip(self.branch_names, g.attrs["nleaves_max"])
            }
            self.ndim = self.ndims[self.branch_names[0]]
            self.iteration = int(g.attrs["iteration"])
            self._accepted = g["accepted"][:]
            self._rj_accepted = np.zeros_like(self._accepted)  # not stored, as in the reference
            self._swaps_accepted = g["swaps_accepted"][:]
            self.info = {k: g["info"].attrs[k] for k in g["info"].attrs} if "info" in g else {}
        return True

    def reset(self, nwalkers, ndims, ntemps=1, nleaves_max=1, branch_names=None, **kwargs):
        import h5py

        super().reset(nwalkers, ndims, ntemps=ntemps, nleaves_max=nleaves_max,
                      branch_names=branch_names, **kwargs)
        with h5py.File(self.filename, "w") as f:
            g = f.create_group(self.group)
            g.attrs["nwalkers"] = self.nwalkers
            g.attrs["ndim"] = self.ndim
            g.attrs["ntemps"] = self.ntemps
            g.attrs["branch_names"] = self.branch_names
            g.attrs["ndims"] = [self.ndims[k] for k in self.branch_names]
            g.attrs["nleaves_max"] = [self.nleaves_max[k] for k in self.branch_names]
            g.attrs["iteration"] = 0
            for name in self.branch_names:
                shape = (0, self.ntemps, self.nwalkers, self.nleaves_max[name], self.ndims[name])
                g.create_dataset(f"chain_{name}", shape=shape, maxshape=(None,) + shape[1:],
                                 dtype=self.dtype)
                g.create_dataset(f"inds_{name}", shape=shape[:-1],
                                 maxshape=(None,) + shape[1:-1], dtype=bool)
            ll_shape = (0, self.ntemps, self.nwalkers)
            for ds in ("log_like", "log_prior"):
                g.create_dataset(ds, shape=ll_shape, maxshape=(None,) + ll_shape[1:],
                                 dtype=self.dtype)
            g.create_dataset("betas", shape=(0, self.ntemps), maxshape=(None, self.ntemps),
                             dtype=self.dtype)
            g.create_dataset("accepted", data=np.zeros((self.ntemps, self.nwalkers)))
            g.create_dataset("swaps_accepted", data=np.zeros((max(self.ntemps - 1, 0),)))
            g.create_dataset("random_state", shape=(2,), dtype=np.uint32)
            g.create_group("info")

    def save_step(self, state: State, accepted, rj_accepted=None, swap_frac=None, **kwargs):
        import h5py

        if rj_accepted is not None:
            self._rj_accepted = self._rj_accepted + self._accepted_increment(rj_accepted)

        with h5py.File(self.filename, "a") as f:
            g = f[self.group]
            it = int(g.attrs["iteration"])
            entries = [
                ("log_like", _np(state.log_like)),
                ("log_prior", _np(state.log_prior)),
                ("betas", _np(state.betas)),
            ]
            for name in self.branch_names:
                coords, inds = self._stored(state.branches[name])
                entries += [(f"chain_{name}", coords), (f"inds_{name}", inds)]
            for ds_name, val in entries:
                ds = g[ds_name]
                ds.resize(it + 1, axis=0)
                ds[it] = val
            g["accepted"][:] = g["accepted"][:] + self._accepted_increment(accepted)
            if swap_frac is not None and len(np.atleast_1d(_np(swap_frac))):
                g["swaps_accepted"][:] = g["swaps_accepted"][:] + _np(swap_frac)
            if state.random_state is not None:
                g["random_state"][:] = _seed_words(int(state.random_state))
            g.attrs["iteration"] = it + 1
            for k, v in self.info.items():
                try:
                    g["info"].attrs[k] = v
                except TypeError:
                    g["info"].attrs[k] = str(v)
        self.iteration += 1
        self._rstate = state.random_state

    def _read(self, ds_name, discard=0, thin=1):
        import h5py

        with h5py.File(self.filename, "r") as f:
            return f[self.group][ds_name][discard::thin]

    def get_chain(self, discard: int = 0, thin: int = 1, temp_index=None, **kwargs):
        out = {}
        for name in self.branch_names:
            chain = self._read(f"chain_{name}", discard, thin)
            out[name] = chain[:, temp_index] if temp_index is not None else chain
        return out

    def get_inds(self, discard: int = 0, thin: int = 1, **kwargs):
        return {name: self._read(f"inds_{name}", discard, thin) for name in self.branch_names}

    def get_nleaves(self, discard: int = 0, thin: int = 1, **kwargs):
        return {name: self._read(f"inds_{name}", discard, thin).sum(axis=-1)
                for name in self.branch_names}

    def get_log_like(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._read("log_like", discard, thin)

    def get_log_prior(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._read("log_prior", discard, thin)

    def get_betas(self, discard: int = 0, thin: int = 1, **kwargs):
        return self._read("betas", discard, thin)

    def get_last_sample(self) -> State:
        """The last stored iteration; ``random_state`` is the seed the two
        stored words hold (see the module docstring)."""
        import h5py

        with h5py.File(self.filename, "r") as f:
            g = f[self.group]
            it = int(g.attrs["iteration"])
            chains = {n: g[f"chain_{n}"][it - 1] for n in self.branch_names}
            inds = {n: g[f"inds_{n}"][it - 1] for n in self.branch_names}
            ll, lp, betas = g["log_like"][it - 1], g["log_prior"][it - 1], g["betas"][it - 1]
            seed = _seed_of_words(g["random_state"][:])
        return self._last_state(chains, inds, ll, lp, betas, seed)

    @property
    def acceptance_fraction(self):
        import h5py

        with h5py.File(self.filename, "r") as f:
            acc = f[self.group]["accepted"][:]
            it = int(f[self.group].attrs["iteration"])
        return acc / max(it, 1)


class TempHDFBackend:
    """Context-managed throwaway HDF backend."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.filename = None

    def __enter__(self) -> HDFBackend:
        import tempfile

        fd, self.filename = tempfile.mkstemp(suffix=".h5")
        os.close(fd)
        os.unlink(self.filename)
        return HDFBackend(self.filename, **self.kwargs)

    def __exit__(self, *exc):
        if self.filename and os.path.exists(self.filename):
            os.unlink(self.filename)
        return False


__all__ = ["HDFBackend", "TempHDFBackend"]
