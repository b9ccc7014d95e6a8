"""The PyTorch port's time-domain path and facades, against the JAX package.

Same seeded inputs through both packages: the taper windows, the spline
evaluation at given segments, the dense TD mode sum on a carried prologue,
the host-side FD utilities, the DFT at selected bins, the signed-grid FD
channels, the detector-frame helpers, the user-facing generators and the
FD/TD Hann mismatch. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models import summation_td as j_td
from emri_frequencydomainwaveforms_tpu.ops import cubic_spline as j_cs
from emri_frequencydomainwaveforms_tpu.utils import fdutils as j_fdu
from emri_frequencydomainwaveforms_tpu.utils import windows as j_win
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import summation_td as t_td
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.ops import cubic_spline as t_cs
from emri_frequencydomainwaveforms_tpu_torch.utils import fdutils as t_fdu
from emri_frequencydomainwaveforms_tpu_torch.utils import windows as t_win

SOURCE = (1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0)
PARS = [1e6, 50.0, 0.0, 10.0, 0.4, 1.0, 1.0, np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6, 1.0,
        0.0, 2.0]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    """A 0.02-yr reference prologue (l <= 2 table, eps selection) and its
    port copy."""
    table = default_mode_table(8, l_max=2)
    kw = dict(t_years=0.02, table=table, k_max=12, eps=1e-2, max_steps=128)
    pro_j = jax.jit(lambda: j_wf.waveform_prologue(*SOURCE, **kw))()
    pro_t = convert.prologue_from_numpy(jax.tree_util.tree_map(np.asarray, pro_j), device="cpu")
    return table, convert.mode_table_from_numpy(*table), pro_j, pro_t


def _rel_l2(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.linalg.norm(ref - got) / np.linalg.norm(ref)


@pytest.mark.parametrize("name", sorted(j_win.WINDOWS))
def test_windows(name):
    # tolerance 1e-15 absolute (the windows are O(1))
    for n in (2, 7, 1000):
        ref = np.asarray(j_win.WINDOWS[name](n))
        got = t_win.WINDOWS[name](n).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)


def test_spline_eval_at_segments():
    # tolerance 1e-12 relative to the values' scale
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(0, 10, 40))
    y = np.sin(x) + 0.1 * rng.normal(size=(3, 40))
    xq = rng.uniform(x[0], x[-1], 500)
    sp_j = j_cs.fit_cubic_spline(jnp.asarray(x), jnp.asarray(y), bc="not-a-knot")
    seg_j = j_cs._segment_index(jnp.asarray(x), jnp.asarray(xq))
    xt = torch.from_numpy(x)
    sp_t = t_cs.fit_cubic_spline(xt, torch.from_numpy(y), bc="not-a-knot")
    seg_t = t_cs._segment_index(xt, torch.from_numpy(xq))
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    for deriv in (0, 1, 2):
        for i in range(3):
            ref = np.asarray(j_cs.spline_eval_at_segments(
                j_cs.CubicSplineCoeffs(sp_j.x, sp_j.c[i]), seg_j, jnp.asarray(xq), deriv=deriv))
            # the three splines as a batch: knots (B, n), queries (B, m)
            batched = t_cs.spline_eval_at_segments(
                t_cs.CubicSplineCoeffs(xt.expand(3, -1), sp_t.c), seg_t.expand(3, -1),
                torch.from_numpy(xq).expand(3, -1), deriv=deriv)[i]
            scale = np.max(np.abs(ref))
            assert np.max(np.abs(batched.numpy() - ref)) <= 1e-12 * scale


def test_td_waveform_core_on_carried_prologue(carried):
    # tolerance: relative L2 <= 1e-5 per polarization (float32 accumulation)
    table, t_table, pro_j, pro_t = carried
    t_grid = j_wf.default_time_grid(0.02, 10.0)
    ref = jax.jit(lambda p: j_wf.td_waveform_core(p, table, jnp.asarray(t_grid)))(pro_j)
    got = t_wf.td_waveform_core(pro_t, t_table, t_grid)
    for a, b in zip(ref, got):
        assert b.shape == (1, len(t_grid)) and b.dtype == torch.float64
        assert np.all(np.isfinite(b.numpy()))
        assert _rel_l2(a, b[0]) <= 1e-5
    # the same prologue in a batch of two lanes gives the same lane 0
    two = pro_t._replace(**{f: torch.cat([getattr(pro_t, f)] * 2)
                            for f in ("t_knots", "n_live", "phi_phi", "phi_r", "a_re", "a_im",
                                      "t_end", "dist_factor")},
                         sel=type(pro_t.sel)(*(torch.cat([x] * 2) for x in pro_t.sel)),
                         y_plus=tuple(torch.cat([x] * 2) for x in pro_t.y_plus),
                         y_minus=tuple(torch.cat([x] * 2) for x in pro_t.y_minus))
    got2 = t_wf.td_waveform_core(two, t_table, t_grid)
    for a, b in zip(got, got2):
        np.testing.assert_array_equal(b[1].numpy(), a[0].numpy())
    # direct summation at the knots
    ref_d = jax.jit(lambda p: j_td.DirectModeSum()(p, table))(pro_j)
    got_d = t_td.DirectModeSum()(pro_t, t_table)
    for a, b in zip(ref_d, got_d):
        assert _rel_l2(a, b[0]) <= 1e-5


def test_fdutils_host_functions():
    # tolerance 1e-12 relative to the output's max
    rng = np.random.default_rng(5)
    n = 257
    a = rng.normal(size=n) + 1j * rng.normal(size=n)
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    td = [rng.normal(size=n), rng.normal(size=n)]
    w = np.hanning(n)
    pairs = [
        (j_fdu.get_convolution(a, b), t_fdu.get_convolution(a, b)),
        (j_fdu.get_fft_td_windowed(td, w, 10.0), t_fdu.get_fft_td_windowed(td, w, 10.0)),
        (j_fdu.get_fd_windowed([a, b], w), t_fdu.get_fd_windowed([a, b], w)),
        (j_fdu.get_fd_windowed([a], np.fft.fft(w), window_in_fd=True),
         t_fdu.get_fd_windowed([a], np.fft.fft(w), window_in_fd=True)),
    ]
    mask = np.fft.fftshift(np.fft.fftfreq(n)) > 0
    nz = rng.random(mask.sum()) > 0.2
    gen = lambda *args: [np.fft.fftshift(np.fft.fft(x)) for x in td]  # noqa: E731
    pairs.append((j_fdu.get_fd_waveform_fromFD(gen, mask, 10.0, nz, w)(),
                  t_fdu.get_fd_waveform_fromFD(gen, mask, 10.0, nz, w)()))
    tdgen = lambda *args: td  # noqa: E731
    pairs.append((j_fdu.get_fd_waveform_fromTD(tdgen, mask, 10.0, nz, w)(),
                  t_fdu.get_fd_waveform_fromTD(tdgen, mask, 10.0, nz, w)()))
    for ref, got in pairs:
        for r, g in zip(np.atleast_2d(np.asarray(ref)), np.atleast_2d(np.asarray(got))):
            assert np.max(np.abs(r - g)) <= 1e-12 * np.max(np.abs(r))


def test_dft_at_bins():
    # the reference's float32-angle DFT carries ~1e-7 rad of phase error;
    # the port's float64 rfft is held to it at 1e-6 of the spectrum's max
    rng = np.random.default_rng(9)
    n_t = 4001  # odd, as the default time grid
    h = rng.normal(size=(2, n_t)).cumsum(axis=-1)
    idx = np.arange(1, (n_t + 1) // 2)[::7]
    re_j, im_j = j_fdu.dft_at_bins(jnp.asarray(h), jnp.asarray(idx), n_t)
    re_t, im_t = t_fdu.dft_at_bins(torch.from_numpy(h), idx, n_t)
    exact = np.fft.rfft(h, axis=-1)[..., idx]
    scale = np.max(np.abs(exact))
    assert re_t.dtype == torch.float64 and re_t.shape == (2, len(idx))
    assert np.max(np.abs(re_t.numpy() - np.asarray(re_j))) <= 1e-6 * scale
    assert np.max(np.abs(im_t.numpy() - np.asarray(im_j))) <= 1e-6 * scale
    # and the port's equals numpy's float64 rfft to rounding
    assert np.max(np.abs(re_t.numpy() + 1j * im_t.numpy() - exact)) <= 1e-12 * scale


def test_assemble_and_signed_grid_channels(carried):
    table, t_table, pro_j, pro_t = carried
    # assembly helpers: exact
    freq = np.fft.fftshift(np.fft.fftfreq(11, 10.0))
    rng = np.random.default_rng(2)
    hp = rng.normal(size=5) + 1j * rng.normal(size=5)
    hc = rng.normal(size=5) + 1j * rng.normal(size=5)
    for sym in (True, False):
        for ref, got in zip(j_wf._assemble_channels(freq, hp, hc, sym),
                            t_wf._assemble_channels(freq, hp, hc, sym)):
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(t_wf._assemble_scalar(freq, hp, hc, sym),
                                      j_wf._assemble_scalar(freq, hp, hc, sym))
    # channels and scalar on an irregular signed grid through the general
    # kernel, with turnover and negative slots: relative L2 <= 1e-5
    f = np.sort(rng.uniform(1.2e-3, 6e-3, 900))
    grid = np.concatenate([-f[::-1][::3], [0.0], f])
    kw = dict(turnover_slots=2, negative_slots=1)
    ref_c = jax.jit(lambda p: j_wf.fd_channels_on_grid(p, table, jnp.asarray(grid), **kw))(pro_j)
    got_c = t_wf.fd_channels_on_grid(pro_t, t_table, grid, **kw)
    ref_s = jax.jit(lambda p: j_wf.fd_scalar_on_grid(p, table, jnp.asarray(grid), **kw))(pro_j)
    got_s = t_wf.fd_scalar_on_grid(pro_t, t_table, grid, **kw)
    for ref, got in ((ref_c[0], got_c[0]), (ref_c[1], got_c[1]), (ref_s, got_s)):
        for a, b in zip(ref, got):
            assert b.shape == (1, len(grid))
            assert _rel_l2(a, b[0]) <= 1e-5
            assert b[0, len(f[::3])] == 0.0  # f = 0


def test_detector_frame_and_rotation():
    # tolerance 1e-12 absolute on angles; the rotation exact to rounding
    rng = np.random.default_rng(4)
    ang = rng.uniform([0, 0, 0, 0], [np.pi, 2 * np.pi, np.pi, 2 * np.pi], (6, 4))
    ang[0] = [np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6]
    ang[1, 2] = 0.0  # L along z: the degenerate basis
    for row in ang:
        ref = j_wf.detector_frame_angles(*(jnp.asarray(v) for v in row))
        got = t_wf.detector_frame_angles(*row)
        for a, b in zip(ref, got):
            assert abs(float(a) - float(b)) <= 1e-12
    got_b = t_wf.detector_frame_angles(*(torch.from_numpy(ang[:, i]) for i in range(4)))
    assert got_b[0].shape == (6,)
    hp, hc = rng.normal(size=(2, 50))
    ref = j_wf.rotate_polarizations(jnp.asarray(hp), jnp.asarray(hc), 0.3)
    got = t_wf.rotate_polarizations(torch.from_numpy(hp), torch.from_numpy(hc), torch.tensor(0.3,
                                    dtype=torch.float64))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-15)


def _jax_facade_channels(T, dt, eps, n_max, l_max, k_max=64):
    """[h+, hx] of the JAX package's GenerateEMRIWaveform(return_list=True,
    flux="pm") for PARS, TD and FD on the default grid: the same calls its
    __call__ makes (detector_frame_angles, waveform_prologue, the TD or the
    banded FD core with 2 turnover slots, _assemble_channels, the 2 psi
    rotation), each jitted once instead of run op by op."""
    table = default_mode_table(n_max, l_max=l_max)
    (M, mu, _, p0, e0, _, dist, qS, phiS, qK, phiK, ph0, _, pr0) = PARS
    theta, phi, psi = j_wf.detector_frame_angles(*(jnp.asarray(v) for v in (qS, phiS, qK, phiK)))
    pro = jax.jit(lambda: j_wf.waveform_prologue(
        M, mu, p0, e0, theta, phi, dist, ph0, pr0, t_years=T, table=table, k_max=k_max, eps=eps,
        flux="pm", tail=True, factorized=True, rwz=True))()
    hp_td, hc_td = jax.jit(lambda p: j_wf.td_waveform_core(
        p, table, jnp.asarray(j_wf.default_time_grid(T, dt))))(pro)
    freq = j_wf.default_frequencies(T, dt)
    f_pos, f0, df, sym = j_wf._detect_uniform_grid(freq)
    o = jax.jit(lambda p: j_wf.fd_waveform_core(p, table, jnp.asarray(f_pos), channels=True,
                                               uniform=(f0, df), turnover_slots=2))(pro)
    o = [np.asarray(x) for x in o]
    hp_fd, hc_fd = j_wf._assemble_channels(freq, o[0] + 1j * o[1], o[2] + 1j * o[3], sym)
    c2, s2 = float(jnp.cos(2 * psi)), float(jnp.sin(2 * psi))
    td = [np.asarray(hp_td) * c2 - np.asarray(hc_td) * s2, np.asarray(hp_td) * s2 + np.asarray(hc_td) * c2]
    fd = [hp_fd * c2 - hc_fd * s2, hp_fd * s2 + hc_fd * c2]
    return td, fd, freq


@pytest.fixture(scope="module")
def facade_waveforms():
    """tests/test_waveform.py's FD/TD configuration (0.1 yr, n_max 16,
    l <= 3, eps 1e-2) with the Peters-Mathews flux (the two packages
    integrate it to ~1e-12) and the default amplitude rungs: [h+, hx], TD
    and FD, from the port's GenerateEMRIWaveform and from the JAX package's
    calls behind its GenerateEMRIWaveform, and the FD grid."""
    call = dict(T=0.1, dt=10.0, eps=1e-2)
    kw = dict(return_list=True, n_max=16, l_max=3, device="cpu")
    td = t_wf.GenerateEMRIWaveform(sum_kwargs=dict(odd_len=True, flux="pm"), **kw)
    fd = t_wf.GenerateEMRIWaveform(sum_kwargs=dict(output_type="fd", odd_len=True, flux="pm"), **kw)
    out = {"torch": (td(*PARS, **call), fd(*PARS, **call), fd.frequency),
           "jax": _jax_facade_channels(0.1, 10.0, 1e-2, 16, 3)}
    # the scalar form of the port's facade: h+ - i hx
    scalar = t_wf.GenerateEMRIWaveform(sum_kwargs=dict(odd_len=True, flux="pm"),
                                       **{**kw, "return_list": False})
    out["torch_scalar"] = scalar(*PARS, **call)
    return out


@pytest.mark.parametrize("output", ["td", "fd"])
def test_generate_emri_waveform_facade(facade_waveforms, output):
    # relative L2 <= 1e-5 per channel against the JAX package's
    k = 0 if output == "td" else 1
    ref, got = facade_waveforms["jax"][k], facade_waveforms["torch"][k]
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape and np.iscomplexobj(b) == np.iscomplexobj(a)
        assert _rel_l2(a, b) <= 1e-5
    if output == "fd":
        np.testing.assert_array_equal(facade_waveforms["torch"][2], facade_waveforms["jax"][2])
    else:
        hp, hc = got
        np.testing.assert_array_equal(facade_waveforms["torch_scalar"], hp - 1j * hc)


def test_fd_td_hann_mismatch(facade_waveforms):
    # the port's own windowed FD/TD mismatch is below tests/test_waveform.py's
    # 5e-4 and within 10 % of the JAX package's at the same configuration
    mm = {}
    for name in ("jax", "torch"):
        htd, hfd, freq = facade_waveforms[name]
        w = np.hanning(len(htd[0]))
        pos = freq >= 0
        mm[name] = [
            1.0 - np.abs(np.vdot(a[pos], b[pos]))
            / np.sqrt(np.vdot(a[pos], a[pos]).real * np.vdot(b[pos], b[pos]).real)
            for a, b in zip(t_fdu.get_fd_windowed(hfd, w), t_fdu.get_fft_td_windowed(htd, w, 10.0))
        ]
    for got, ref in zip(mm["torch"], mm["jax"]):
        assert got < 5e-4
        assert abs(got - ref) <= 0.1 * ref
