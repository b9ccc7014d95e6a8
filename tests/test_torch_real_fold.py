"""The port's fold treatment at a real plunging source against brute force.

Mirror of ``tests/test_real_fold.py`` for the PyTorch port: harmonic
(m, n) = (2, 10) of a plunging 1e6 / 50, e0 = 0.5 source folds with Airy
depth z ~ 9, so its fringe band holds several O(1) two-branch interference
fringes. The truth is the direct oscillatory integral of the same
single-mode signal the kernels integrate (its amplitude tapered by C^1
cosine ramps and refit at the knots), by dense trapezoid on >= 40 samples
per cycle (`testing/truth.py::fold_brute_force`, evaluating the shared
splines in numpy); the case is `testing/truth_cases.py::fold_case`, which
``chip_smoke.py``'s ``[truth]`` phase runs on the card. Same bounds as the
reference: two-branch RMS < 0.12 (the port reads 0.059, JAX 0.059),
single branch > 3x that (0.46), the banded production kernel (runs of 16
bins, 4 turnover slots, 2048-run windows) < 0.12 and within 2e-2 of the
general kernel.

The last case runs the JAX package's general and banded kernels on the
port's fold inputs: relative L2 <= 1e-5 each (float32 sin/cos and
accumulation in both).
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.models.summation_fd import fd_mode_sum
from emri_frequencydomainwaveforms_tpu_torch.testing import truth
from emri_frequencydomainwaveforms_tpu_torch.testing.truth_cases import fold_banded
from emri_frequencydomainwaveforms_tpu_torch.testing.truth_cases import fold_case as _fold_case


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fold_case():
    return _fold_case(device="cpu")


def _complex(o):
    return o[0][0].numpy() + 1j * o[1][0].numpy()


def _general(case, turnover_slots):
    return _complex(fd_mode_sum(case["sm"], torch.from_numpy(case["fs"]),
                                turnover_slots=turnover_slots))


class TestRealFoldBruteForce:
    def test_fringes_present(self, fold_case):
        # the band really holds O(1) two-branch interference fringes
        a = np.abs(fold_case["bv"]) / fold_case["scale"]
        assert a.min() < 0.5 and a.max() > 1.3

    def test_two_branch_matches_brute_force(self, fold_case):
        # the reference measures 0.059 RMS: the shared SPA + Bessel residual at z ~ 9
        assert truth.rms(_general(fold_case, 1), fold_case) < 0.12

    def test_single_branch_misses_fringes(self, fold_case):
        k0, k1 = _general(fold_case, 0), _general(fold_case, 1)
        # the reference measures 0.46 vs 0.059: the fringes are two-branch content
        assert truth.rms(k0, fold_case) > 3 * truth.rms(k1, fold_case)

    def test_banded_production_kernel_matches_brute_force(self, fold_case):
        # the production banded kernel at the real fold bins
        kb = fold_banded(fold_case)
        assert truth.rms(kb, fold_case) < 0.12  # the reference measures 0.060
        # and it adds no fold error over the general kernel (the reference
        # measures a banded-vs-general gap < 1e-2 of scale at the fold bins)
        kg = _general(fold_case, 1)
        gap = np.sqrt(np.mean(np.abs(kb - kg) ** 2)) / fold_case["scale"]
        assert gap < 2e-2


def test_general_kernel_against_the_reference(fold_case):
    """The JAX package's general kernel on the port's fold inputs, both
    branches, at the fringe bins; both packages' distances to the truth are
    printed with ``-s``, to be read beside the card's values that
    ``chip_smoke.py``'s ``[truth]`` prints."""
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.models import summation_fd as j_sfd

    inp = j_sfd.FDKernelInputs(*(jnp.asarray(x[0].numpy()) for x in fold_case["sm"]))
    fs = jnp.asarray(fold_case["fs"])
    ref = j_sfd.fd_mode_sum(inp, fs, turnover_slots=1)
    got = fd_mode_sum(fold_case["sm"], torch.from_numpy(fold_case["fs"]), turnover_slots=1)
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b[0].numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(a)

    def rms(o):
        return truth.rms(np.asarray(o[0]) + 1j * np.asarray(o[1]), fold_case)

    bb = j_sfd.fd_mode_sum_uniform(
        inp, fold_case["f0"], fold_case["df"], fold_case["nf"], bins_per_run=16,
        turnover_slots=4, negative_slots=0, extra_band_runs=2048,
    )
    kb = (np.asarray(bb[0]) + 1j * np.asarray(bb[1]))[fold_case["idx"]]
    kg = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    gap = np.sqrt(np.mean(np.abs(kb - kg) ** 2)) / fold_case["scale"]
    print(f"JAX on the port's fold inputs: two-branch RMS {rms(ref):.4e}, single branch "
          f"{rms(j_sfd.fd_mode_sum(inp, fs, turnover_slots=0)):.4e}, banded "
          f"{truth.rms(kb, fold_case):.4e}, banded vs general gap {gap:.4e}")
    kb_t = fold_banded(fold_case)
    print(f"port: two-branch RMS {truth.rms(_complex(got), fold_case):.4e}, single branch "
          f"{truth.rms(_general(fold_case, 0), fold_case):.4e}, banded "
          f"{truth.rms(kb_t, fold_case):.4e}, banded vs general gap "
          f"{np.sqrt(np.mean(np.abs(kb_t - _complex(got)) ** 2)) / fold_case['scale']:.4e}")
    assert np.linalg.norm(kb_t - kb) <= 1e-5 * np.linalg.norm(kb)
