"""The banded FD dense pass of the PyTorch port against the JAX package.

* level-1 tables: the port's searchsorted segment lookup vs the reference's
  one-hot selection, on identical (converted) inputs;
* `fd_dense_accumulate_reference` on the reference's own level-1 tables vs
  the reference's XLA dense chain (``_return_padded``): float32-ulp level,
  the two differ only in the sin/cos implementations;
* the port's `fd_mode_sum_uniform` (turnover + negative slots included) vs
  the reference's: float32 level;
* the plain version vs the Pallas kernel in interpret mode (no cycle
  term): <= 1e-4 max/scale, the reference's own Pallas-vs-XLA tolerance;

The kernel's own tests (no JAX needed) are in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import summation_fd as j_fd
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models.waveform import _sigma, waveform_prologue
from emri_frequencydomainwaveforms_tpu.ops.pallas import fd_dense as j_pallas
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd as t_fd
from emri_frequencydomainwaveforms_tpu_torch.ops import fd_dense as t_dense

F0, DF, NF, R, BAND_RUNS = 1.7e-3, 2e-8, 20000, 8, 2048


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fd_inputs():
    """Reference FDKernelInputs of a 0.05-yr source (tests/test_waveform.py's
    Pallas configuration), with negative-branch weights."""
    table = default_mode_table(30)

    @jax.jit
    def build():
        pro = waveform_prologue(
            1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0,
            t_years=0.05, table=table, k_max=16, eps=1e-2,
        )
        sig = _sigma(table)
        ypr, ypi = pro.y_plus
        ymr, ymi = pro.y_minus
        return j_fd.prepare_fd_inputs(
            pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im,
            table, pro.sel, (sig * ymr, sig * ymi), (ypr, -ypi),
            w1n=(ypr, ypi), w2n=(sig * ymr, -sig * ymi),
        )

    return build()


def _main_slot_args(inp):
    """(cphi, ar, ai, f_knots, g0, k_lo, k_hi, dirn) of the main slots, as
    the reference's fd_mode_sum_uniform assembles them (per-lane offsets)."""
    cphi = inp.m_sel[:, None, None] * inp.c_phi_phi[None] + inp.n_sel[:, None, None] * inp.c_phi_r[None]
    fk = inp.m_sel[:, None] * inp.f_phi_knots[None, :] + inp.n_sel[:, None] * inp.f_r_knots[None, :]
    g_total = -(-NF // R)
    f_start = jnp.take_along_axis(fk, inp.inc_lo[:, None], axis=1)[:, 0]
    g0 = jnp.clip(jnp.floor((f_start - F0) / (R * DF)).astype(jnp.int32), 0, g_total)
    dirn = jnp.ones((cphi.shape[0],), jnp.int32)
    return cphi, inp.ar_c, inp.ai_c, fk, g0, inp.inc_lo, inp.inc_hi, dirn


def _t(x):
    return torch.from_numpy(np.array(x))[None]


def test_level1_tables_match_reference(fd_inputs):
    args = _main_slot_args(fd_inputs)
    g_band = min(BAND_RUNS, -(-NF // R))
    ref = jax.jit(
        lambda *a: j_fd._level1_uniform_tables(
            *a, fd_inputs.t_knots, F0, DF, R, g_band + 1, R * DF, cycle_split=True
        )
    )(*args)
    got = t_fd._level1_uniform_tables(
        *(_t(a) for a in args), _t(fd_inputs.t_knots), F0, DF, R, g_band + 1, R * DF,
        cycle_split=True,
    )
    live = np.asarray(fd_inputs.inc_live) > 0
    assert live.sum() >= 8
    pc_r, nc_r, ec_r, fs_r, fe_r = (np.asarray(x)[live] for x in ref)
    pc_g, nc_g, ec_g, fs_g, fe_g = (x[0].numpy()[live] for x in got)
    np.testing.assert_array_equal(fs_g, fs_r)
    np.testing.assert_array_equal(fe_g, fe_r)
    # the integer cycle counts agree except where a phase coefficient sits
    # within float rounding of a half-cycle; the residuals then differ by 2pi
    # together with the count, so compare the recombined coefficient
    full_r = pc_r[..., 1:] + 2 * np.pi * nc_r
    full_g = pc_g[..., 1:] + 2 * np.pi * nc_g
    assert np.mean(nc_r == nc_g) > 0.999
    assert np.max(np.abs(full_r - full_g) / np.maximum(np.abs(full_r), 1.0)) < 1e-5
    assert np.max(np.abs(np.angle(np.exp(1j * (pc_r[..., 0] - pc_g[..., 0]))))) < 1e-4
    scale = np.max(np.abs(ec_r[..., :4]))
    assert np.max(np.abs(ec_r[..., :4] - ec_g[..., :4])) / scale < 1e-5
    assert np.max(np.abs(ec_r[..., 4:] - ec_g[..., 4:])) < 1e-4


def test_reference_dense_on_reference_tables(fd_inputs):
    inp = fd_inputs
    args = _main_slot_args(inp)
    g_band = min(BAND_RUNS, -(-NF // R))
    pc, nc, ec, fs, fe = jax.jit(
        lambda *a: j_fd._level1_uniform_tables(
            *a, inp.t_knots, F0, DF, R, g_band + 1, R * DF, cycle_split=True
        )
    )(*args)
    ref = jax.jit(
        lambda i: j_fd.fd_mode_sum_uniform(
            i, F0, DF, NF, bins_per_run=R, band_runs=BAND_RUNS, _return_padded=True
        )
    )(inp)
    grp = t_fd._dense_group(
        (_t(pc), _t(nc), _t(ec), _t(fs), _t(fe)), _t(inp.inc_live),
        [_t(w) for w in (inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im)],
        _t(args[4]), F0, DF, R,
    )
    got = t_dense.fd_dense_accumulate_reference([grp], r=R, nf=NF)
    assert got.shape == (1, 4, NF)
    for c in range(4):
        a = np.asarray(ref[c])[:NF]
        scale = np.max(np.abs(a))
        assert scale > 0
        assert np.max(np.abs(a - got[0, c].numpy())) / scale < 1e-6


def test_fd_mode_sum_uniform_with_extra_slots(fd_inputs):
    kw = dict(bins_per_run=R, band_runs=BAND_RUNS, turnover_slots=2, negative_slots=1,
              extra_band_runs=64)
    ref = jax.jit(lambda i: j_fd.fd_mode_sum_uniform(i, F0, DF, NF, **kw))(fd_inputs)
    got = t_fd.fd_mode_sum_uniform(
        convert.fd_inputs_from_numpy(jax.tree_util.tree_map(np.asarray, fd_inputs), device="cpu"),
        F0, DF, NF, **kw,
    )
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b[0].numpy()
        assert b.dtype == np.float64
        assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-5
        assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < 1e-4


def test_plain_dense_matches_pallas_interpret():
    rng = np.random.default_rng(41)
    m, g_band, r = 4, 128, 8
    nf = 3800
    g_pad = -(-(-(-nf // r) + g_band) // 128) * 128
    pc = rng.uniform(-3.0, 3.0, (m, g_band, 4)).astype(np.float32)
    ec = rng.uniform(-1.0, 1.0, (m, g_band, 8)).astype(np.float32)
    offs = np.array([0, 128, 128, 256], np.int32)  # slots 1 and 2 overlap
    f0, df = 1.7e-3, 2e-8
    # band edges mid-bin (the Pallas body compares float32 frequencies)
    lo_bin = offs * r + rng.integers(5, 300, m)
    hi_bin = np.minimum(lo_bin + rng.integers(200, 900, m), nf - 1)
    f_start = f0 + (lo_bin - 0.5) * df
    f_end = f0 + (hi_bin + 0.5) * df
    live = np.array([1.0, 1.0, 1.0, 0.0])
    pc[:, 0, :] = np.where(lo_bin[:, None] >= r, np.nan, pc[:, 0, :])  # masked NaN run
    w = rng.standard_normal((m, 4)).astype(np.float32)
    scalars = np.concatenate(
        [f_start[:, None], f_end[:, None], live[:, None], w, np.zeros((m, 1))], axis=1
    ).astype(np.float32)
    out = j_pallas.fd_dense_accumulate(
        jnp.asarray(pc.transpose(0, 2, 1)), jnp.asarray(ec.transpose(0, 2, 1)),
        jnp.asarray(scalars), jnp.asarray(offs), r=r, f0=f0, df=df, g_pad=g_pad, interpret=True,
    )
    ref = np.asarray(out).transpose(0, 2, 1).reshape(4, -1)[:, :nf]

    g0 = torch.from_numpy(offs)[None]
    i_lo = t_fd._to_int32(torch.ceil((torch.from_numpy(f_start) - f0) / df))[None] - g0 * r
    i_hi = t_fd._to_int32(torch.floor((torch.from_numpy(f_end) - f0) / df))[None] - g0 * r
    i_lo = torch.where(torch.from_numpy(live)[None] > 0, i_lo, 2**31 - 1)
    grp = t_dense.DenseGroup(
        torch.from_numpy(pc)[None], torch.zeros((1, m, g_band, 3), dtype=torch.int32),
        torch.from_numpy(ec)[None], i_lo.to(torch.int32), i_hi.to(torch.int32),
        torch.from_numpy(w)[None], g0,
    )
    got = t_dense.fd_dense_accumulate([grp], r=r, nf=nf)[0].numpy()
    assert np.all(np.isfinite(got))
    for c in range(4):
        scale = np.max(np.abs(ref[c]))
        assert np.max(np.abs(got[c] - ref[c])) / scale < 1e-4


def test_fd_mode_sum_uniform_takes_the_kernels_padded_rows(fd_inputs, monkeypatch):
    """The CUDA kernel returns the (B, 4, nf) view of rows padded to a
    multiple of 32 bins (`output_buffer`); `fd_mode_sum_uniform` takes its
    channels as it takes the plain version's, and never reads the pad."""
    nf = NF - 3  # not a multiple of 32: the rows carry 29 pad columns
    inp = convert.fd_inputs_from_numpy(jax.tree_util.tree_map(np.asarray, fd_inputs), device="cpu")
    kw = dict(bins_per_run=R, band_runs=BAND_RUNS, turnover_slots=2, extra_band_runs=64,
              out_dtype=torch.float32)
    ref = t_fd.fd_mode_sum_uniform(inp, F0, DF, nf, **kw)
    seen = []

    def padded(groups, *, r, nf):
        plain = t_dense.fd_dense_accumulate_reference(groups, r=r, nf=nf)
        buf, out = t_dense.output_buffer(plain.shape[0], nf, plain.device)
        buf.fill_(float("nan"))
        out.copy_(plain)
        seen.append(out)
        return out

    monkeypatch.setattr(t_fd, "fd_dense_accumulate", padded)
    got = t_fd.fd_mode_sum_uniform(inp, F0, DF, nf, **kw)
    assert len(seen) == 1 and seen[0].shape == (1, 4, nf)
    assert seen[0].stride(1) == t_dense.padded_bins(nf) > nf
    for a, b in zip(ref, got):
        assert b.shape == (1, nf) and b.dtype == torch.float32
        assert torch.equal(a, b)
