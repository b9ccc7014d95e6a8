"""The port's turnover (fold) and negative-frequency branches against truth.

Mirror of ``tests/test_turnover.py`` for the PyTorch port, at its sources,
grids and thresholds: the manufactured quadratic fold
f(t) = fc - b/2 (t - tc)^2 against its brute-force integral (the
two-branch kernel tracks the O(1) interference fringes, the single branch
cannot), a plunging source whose turnover adds in-band content, the
negative-frequency (direct-term) branch against the golden scipy pipeline
on the mirrored phase, and the banded production kernel against the
general one with the extra slots and in the chirp regime. The truths are
`testing/truth.py`'s copies of the reference test's helpers.

The reference's ``jit`` + ``vmap`` case becomes the port's batch axis:
three walkers with turnover slots through the batched prologue and core,
each row equal to the same walker's B = 1 run to 1e-12.

The last case runs the JAX package's general kernel on the reference's own
synthetic-fold inputs, carried into the port: relative L2 <= 1e-5 (float32
sin/cos and accumulation in both).
"""

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch.models.modeselect import table_indices_for
from emri_frequencydomainwaveforms_tpu_torch.models.summation_fd import (
    fd_mode_sum,
    fd_mode_sum_uniform,
)
from emri_frequencydomainwaveforms_tpu_torch.models.waveform import (
    fd_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu_torch.testing import truth
from emri_frequencydomainwaveforms_tpu_torch.testing import truth_cases as cases

FRINGE_BAND = np.linspace(0.75e-3, 0.985e-3, 10)  # both branches contribute


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _complex(o, lane=0):
    return o[0][lane].numpy() + 1j * o[1][lane].numpy()


class TestSyntheticFold:
    def test_two_branch_matches_brute_force(self):
        inp, (fc, b, tc, T) = cases.synthetic_fold_inputs(device="cpu")
        kw = _complex(fd_mode_sum(inp, torch.from_numpy(FRINGE_BAND), turnover_slots=1))
        bv = truth.synthetic_fold_brute_force(FRINGE_BAND, fc, b, tc, T)
        for i in range(len(FRINGE_BAND)):
            np.testing.assert_allclose(abs(kw[i]) / abs(bv[i]), 1.0, atol=0.03)
            assert abs(np.angle(kw[i] / bv[i])) < 0.03

    def test_single_branch_misses_fringes(self):
        # without turnover slots the fringe pattern cannot appear: the
        # previous test exercises the two-branch path
        inp, _ = cases.synthetic_fold_inputs(device="cpu")
        fs = torch.from_numpy(FRINGE_BAND)
        k0 = np.abs(_complex(fd_mode_sum(inp, fs, turnover_slots=0)))
        k1 = np.abs(_complex(fd_mode_sum(inp, fs, turnover_slots=1)))
        # two-branch spectrum oscillates (fringes); single-branch is smooth
        assert np.std(np.diff(k1)) > 5 * np.std(np.diff(k0))


class TestPlungingSource:
    def test_turnover_adds_finite_inband_content(self):
        # p0 near the separatrix: plunges at ~0.03 yr; mode (2,2,4) turns over
        table = default_mode_table(16, l_max=2)
        pro = waveform_prologue(
            *cases.PLUNGING_SOURCE, t_years=1.0, table=table, k_max=32, eps=1e-2, device="cpu",
        )
        inp = cases.fd_inputs(pro, table, negative=False)
        assert int(inp.dec_live.sum()) >= 1  # a real turnover

        f_grid = torch.from_numpy(np.linspace(1e-3, 7e-3, 2048))
        a1 = _complex(fd_waveform_core(pro, table, f_grid, channels=False, turnover_slots=4))
        a0 = _complex(fd_waveform_core(pro, table, f_grid, channels=False, turnover_slots=0))
        assert np.isfinite(a1).all() and np.isfinite(a0).all()
        diff = np.abs(a1 - a0)
        # the decreasing branch contributes at a level comparable to the
        # local single-branch amplitude, confined to its (narrow) band
        assert diff.max() > 0.1 * np.abs(a0).max()
        contributing = diff > 1e-6 * np.abs(a0).max()
        assert 0 < contributing.sum() < len(f_grid) // 4

    def test_batched_walkers_with_turnover(self):
        # the reference's jit(vmap) over three p0 with turnover slots: here
        # the port's walker axis, each row against its walker alone
        table = default_mode_table(8, l_max=2)
        f_pos = torch.linspace(1e-3, 6e-3, 64, dtype=torch.float64)
        p0s = [7.6, 8.0, 9.0]
        kw = dict(t_years=0.5, table=table, k_max=16, eps=1e-3, device="cpu")

        def gen(p0):
            pro = waveform_prologue(1e6, 50.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0, **kw)
            return fd_waveform_core(pro, table, f_pos, turnover_slots=2)

        out = gen(torch.tensor(p0s, dtype=torch.float64))
        for o in out:
            assert o.shape == (3, 64) and torch.isfinite(o).all()
        for i, p0 in enumerate(p0s):
            for a, b in zip(gen(p0), out):
                scale = float(a[0].abs().max())
                assert scale > 0
                assert float((a[0] - b[i]).abs().max()) <= 1e-12 * scale


class TestNegativeFrequencyBranch:
    """Ranges where f_mn(t) < 0 radiate at +|f| through the direct term
    A Y^+ e^{-i Phi}: the golden pipeline evaluated on the mirrored phase."""

    def test_matches_golden_on_mirrored_phase(self):
        from scipy.interpolate import CubicSpline

        table = default_mode_table(12, l_max=2)
        forced = table_indices_for(table, [(2, 2, -8)])  # f = 2 om_phi - 8 om_r < 0
        pro = waveform_prologue(
            *cases.GOLDEN_SOURCE, t_years=0.25, table=table, k_max=1, eps=1e-2,
            forced_idx=forced, device="cpu",
        )
        n = int(pro.n_live[0])
        t = pro.t_knots[0, :n].numpy()
        phase = 2 * pro.phi_phi[0, :n].numpy() - 8 * pro.phi_r[0, :n].numpy()
        g = -CubicSpline(t, phase).derivative()(t) / (2 * np.pi)
        assert (g > 0).all()  # the mode is negative-frequency throughout
        dg = np.diff(g)
        stop = int(np.argmax(dg <= 0)) if (dg <= 0).any() else n - 1
        assert stop > 20  # a substantial first increasing run of g = -f

        idx = int(forced[0])
        a_re = pro.a_re[0, : stop + 1, idx].numpy()
        a_im = pro.a_im[0, : stop + 1, idx].numpy()
        yp = complex(pro.y_plus[0][0, idx]) + 1j * complex(pro.y_plus[1][0, idx])

        nb = 1024
        f_lo, f_hi = g[0], g[stop]
        pad = (f_hi - f_lo) / nb
        f_grid = np.linspace(f_lo + pad, f_hi - pad, nb)
        golden = truth.golden_fd_positive(
            t[: stop + 1], -phase[: stop + 1], a_re, -a_im, yp, f_grid
        ) * float(pro.dist_factor[0])

        fq = torch.from_numpy(f_grid)
        ours = _complex(fd_waveform_core(pro, table, fq, channels=False, negative_slots=1))
        base = _complex(fd_waveform_core(pro, table, fq, channels=False, negative_slots=0))
        assert np.abs(base).max() == 0.0  # masked without negative slots
        assert np.isfinite(ours).all()
        assert truth.mismatch(golden, ours, np.hanning(nb)) < 1e-4

    def test_channels_mode_finite(self):
        table = default_mode_table(10, l_max=2)
        f_pos = torch.linspace(5e-4, 6e-3, 128, dtype=torch.float64)
        pro = waveform_prologue(
            1e6, 50.0, 9.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=0.25, table=table, k_max=24, eps=1e-3, device="cpu",
        )
        out = fd_waveform_core(
            pro, table, f_pos, channels=True, turnover_slots=2, negative_slots=4
        )
        for o in out:
            assert torch.isfinite(o).all()


@pytest.fixture(scope="module")
def plunging_banded():
    """One plunging prologue, one full-slot and one no-slot banded
    evaluation, shared by the banded-turnover tests."""
    return cases.plunging_banded(device="cpu")


class TestBandedTurnover:
    """The banded uniform production kernel carries the same turnover and
    negative content as the general kernel."""

    def test_banded_matches_general_with_slots(self, plunging_banded):
        inp, (f0, df, nf), banded, _b0 = plunging_banded
        assert int(inp.dec_live.sum()) >= 1
        f = torch.from_numpy(f0 + df * np.arange(nf))
        general = fd_mode_sum(inp, f, turnover_slots=4, negative_slots=4)
        for b, g in zip(banded, general):
            b, g = b[0].numpy(), g[0].numpy()
            scale = np.sqrt(np.mean(b**2)) + 1e-300
            rel = np.sqrt(np.mean((b - g) ** 2)) / scale
            # fold-resolution limit of the uniform-in-f node grid:
            # percent-level at the fold bins, ~2e-7 elsewhere
            assert rel < 2e-2

    def test_banded_turnover_adds_content(self, plunging_banded):
        _inp, _grid, banded, b0 = plunging_banded
        b4, b0 = banded[0][0].numpy(), b0[0].numpy()
        rel = np.sqrt(np.mean((b4 - b0) ** 2)) / np.sqrt(np.mean(b0**2))
        assert 1e-4 < rel < 0.5  # real, bounded decreasing/negative content
        assert np.isfinite(b4).all()

    @pytest.mark.parametrize("physics,limit", [
        (dict(), 1e-5),
        (dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True), 1e-4),
    ], ids=["chirp_regime_agreement_tight", "chirp_agreement_rwz_physics"])
    def test_chirp_regime(self, physics, limit):
        # a non-plunging source: banded (dead extra slots included) against
        # general at the interpolation-error level over the whole band,
        # edges included; the full calibrated amplitude stack rotates each
        # mode's envelope phase with omega (the reference's limits)
        table = default_mode_table(30)
        pro = waveform_prologue(
            1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0,
            t_years=0.05, table=table, k_max=16, eps=1e-2, device="cpu", **physics,
        )
        inp = cases.fd_inputs(pro, table, negative=False)
        f0, df, nf = 1.7e-3, 2e-8, 60000
        f = torch.from_numpy(f0 + df * np.arange(nf))
        banded = fd_mode_sum_uniform(
            inp, f0, df, nf, bins_per_run=8, band_runs=4096, turnover_slots=2
        )
        general = fd_mode_sum(inp, f, turnover_slots=2)
        for b, g in zip(banded, general):
            b, g = b[0].numpy(), g[0].numpy()
            scale = np.sqrt(np.mean(b**2)) + 1e-300
            assert np.sqrt(np.mean((b - g) ** 2)) / scale < limit


def test_synthetic_fold_on_the_reference_inputs():
    """The JAX general kernel and the port's on the reference's own
    synthetic-fold inputs, both branches."""
    import jax
    import jax.numpy as jnp

    from emri_frequencydomainwaveforms_tpu.models.summation_fd import fd_mode_sum as j_sum
    from emri_frequencydomainwaveforms_tpu_torch import convert
    from tests.test_turnover import _synthetic_fold_inputs

    inp, _ = _synthetic_fold_inputs()
    ref = j_sum(inp, jnp.asarray(FRINGE_BAND), turnover_slots=1)
    inp_t = convert.fd_inputs_from_numpy(jax.tree_util.tree_map(np.asarray, inp), device="cpu")
    got = fd_mode_sum(inp_t, torch.from_numpy(FRINGE_BAND), turnover_slots=1)
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b[0].numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(a)
