"""The numpy helpers the tool twins copy, held to their originals bit for bit.

The torch twins of the root-level tools (``tools/torch_*.py``,
``tools/rwz/torch_*.py``) import neither JAX nor an original that does, so
they carry their own copies of the originals' numpy code: the eccentric
table's cleaning and writer (`tools/rwz/calibrate_ecc.py`), the extension's
checkpoint files (`tools/rwz/calibrate_ecc_extend.py`), the circular
table's grid and writer (`tools/rwz/calibrate.py`), the small-e fits
(`tools/rwz/pn_ecc_flux.py`) and the torus algebra of
`tools/derive_multipoles.py`. Each copy runs beside its original on the
same inputs and must give the same bits (the same text, for the writers).
The committed tables' regeneration from the committed raw files is held to
the committed port copies byte for byte.
"""

import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from tools.rwz import calibrate_ecc as j_ecc
from tools.rwz import calibrate_ecc_extend as j_ext
from tools.rwz import torch_calibrate as t_cal
from tools.rwz import torch_calibrate_ecc as t_ecc
from tools.rwz import torch_calibrate_ecc_extend as t_ext

ROOT = Path(__file__).resolve().parents[1]
PORT_MODELS = ROOT / "emri_frequencydomainwaveforms_tpu_torch" / "models"


def _raw_like(seed, shape=(7, 5), n_rows=6, with_errs=True):
    """Residual grids shaped like a raw solve: smooth fields near 1 with
    R = 1 holes, isolated glitches (modulus spikes, phase flips) and
    per-node errors, some above the rejection threshold."""
    rng = np.random.default_rng(seed)
    rows, errs = {}, {}
    for k in range(n_rows):
        u, e = np.meshgrid(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]),
                           indexing="ij")
        r = (1.0 + 0.1 * u * e + 0.02 * rng.standard_normal(shape)) * np.exp(
            1j * (0.1 * u + 0.05 * rng.standard_normal(shape)))
        r[rng.random(shape) < 0.15] = 1.0  # uncalibrated holes
        spikes = rng.random(shape) < 0.08
        r[spikes] *= rng.choice([3.0, -1.0], size=int(spikes.sum()))
        err = 10.0 ** rng.uniform(-14, -6, shape)
        err[rng.random(shape) < 0.05] = 1e-2
        err[np.abs(r - 1.0) <= 1e-12] = 0.0
        rows[(2 + k % 3, k % 2, k)] = r
        errs[(2 + k % 3, k % 2, k)] = err
    return rows, (errs if with_errs else None)


def _same_tables(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("with_errs", [True, False])
@pytest.mark.parametrize("seed", [1, 2])
def test_clean_table_is_the_original(seed, with_errs):
    rows, errs = _raw_like(seed, with_errs=with_errs)
    ref_rows, ref_errs = j_ecc.clean_table(rows, errs)
    got_rows, got_errs = t_ecc.clean_table(rows, errs)
    _same_tables(ref_rows, got_rows)
    _same_tables(ref_errs, got_errs)
    assert any(not np.array_equal(ref_rows[k], rows[k]) for k in rows)  # it cleaned


def test_cleaning_stages_are_the_original():
    rows, errs = _raw_like(3)
    r, err = next(iter(rows.values())), next(iter(errs.values()))
    field = np.log(np.abs(r))
    assert np.array_equal(t_ecc._medfilt3(field), j_ecc._medfilt3(field))
    assert np.array_equal(t_ecc._wiener_shrink(r), j_ecc._wiener_shrink(r))
    assert np.array_equal(t_ecc._noise_shrink(r, err), j_ecc._noise_shrink(r, err))
    calib = np.abs(r - 1.0) > 1e-12
    for i, j in ((0, 0), (3, 2), (6, 4)):
        assert (t_ecc._calibrated_neighbors(field, np.angle(r), calib, i, j)
                == j_ecc._calibrated_neighbors(field, np.angle(r), calib, i, j))
        assert t_ecc._neighbor_err(err, calib, i, j) == j_ecc._neighbor_err(err, calib, i, j)
    assert (t_ecc.OMEGA_MIN, t_ecc.N_LO, t_ecc.N_HI, t_ecc.MAG_TOL, t_ecc.PH_TOL,
            t_ecc.ERR_REJECT) == (j_ecc.OMEGA_MIN, j_ecc.N_LO, j_ecc.N_HI, j_ecc.MAG_TOL,
                                  j_ecc.PH_TOL, j_ecc.ERR_REJECT)


def test_writer_summary_and_clean_existing_are_the_original(tmp_path):
    rows, errs = _raw_like(4)
    rows, errs = t_ecc.clean_table(rows, errs)
    outs = {}
    for name, mod in (("ref", j_ecc), ("got", t_ecc)):
        path = tmp_path / f"{name}.py"
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.write_table(str(path), rows, -0.5, 0.25, 0.05, 0.1, 7, 5, errs=errs)
            mod._err_summary(rows, errs)
            mod.clean_existing(str(path))
        outs[name] = (path.read_bytes(), buf.getvalue().replace(str(path), "PATH"))
    assert outs["ref"] == outs["got"]


def test_from_raw_is_the_original(tmp_path):
    """``--from-raw`` on the committed raw solve: the same table text and
    the same printed summary as the original's ``--from-raw``."""
    raw = str(ROOT / "tools" / "rwz" / "_rwz_ecc_data_raw.npz")
    outs = {}
    for name, main in (("ref", j_ecc.main), ("got", t_ecc.main)):
        path = tmp_path / f"{name}.py"
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["--from-raw", raw, "--out", str(path)])
        outs[name] = (path.read_bytes(), buf.getvalue().replace(str(path), "PATH"))
    assert outs["ref"] == outs["got"]


def test_assemble_regenerates_the_committed_table(tmp_path):
    """``--assemble`` on the committed checkpoint writes the port's
    committed ``_rwz_ecc_data.py`` byte for byte."""
    path = tmp_path / "ecc.py"
    with redirect_stdout(io.StringIO()):
        t_ext.main(["--assemble", "--out", str(path),
                    "--checkpoint", str(ROOT / t_ext.CKPT)])
    assert path.read_bytes() == (PORT_MODELS / "_rwz_ecc_data.py").read_bytes()


def test_checkpoint_files_are_the_original(tmp_path):
    rows, errs = _raw_like(5)
    done = {(65, 10), (66, 3)}
    grid = np.array([-0.5, 0.25, 0.05, 0.1, 7, 5])
    t_ext._save_ckpt(str(tmp_path / "t.npz"), rows, errs, done, grid)
    j_ext._save_ckpt(str(tmp_path / "j.npz"), rows, errs, done, grid)
    for loader in (t_ext._load_ckpt, j_ext._load_ckpt):
        a = loader(str(tmp_path / "t.npz"))
        b = j_ext._load_ckpt(str(tmp_path / "j.npz"))
        _same_tables(a[0], b[0])
        _same_tables(a[1], b[1])
        assert a[2] == b[2] == done and np.array_equal(a[3], b[3])
    assert (t_ext.RAW, t_ext.CKPT) == (j_ext.RAW, j_ext.CKPT)


def test_circular_grid_and_writer_are_the_original():
    """The B table's grid constants, and its writer: the committed rows
    written again give the port's committed module byte for byte."""
    from emri_frequencydomainwaveforms_tpu_torch.models import _rwz_calibration_data as data
    from tools.rwz import calibrate as j_cal

    assert (t_cal.X_LO, t_cal.X_HI, t_cal.N_X) == (j_cal.X_LO, j_cal.X_HI, j_cal.N_X)
    assert np.array_equal(t_cal.x_grid(),
                          np.exp(np.linspace(np.log(j_cal.X_LO), np.log(j_cal.X_HI), j_cal.N_X)))
    text = "\n".join(t_cal.table_lines(data.B_TABLE)) + "\n"
    assert text == (PORT_MODELS / "_rwz_calibration_data.py").read_text()


def test_small_e_fits_are_the_original():
    from tools.rwz import pn_ecc_flux as j_pn
    from tools.rwz import torch_pn_ecc_flux as t_pn

    ps = [60.0, 100.0, 180.0, 320.0, 560.0]
    gs = 157.0 / 24.0 - 16.1 * np.asarray(ps) ** -1.0 + np.random.default_rng(6).normal(
        0, 1e-3, len(ps))
    for n_terms in (4, 5):
        ref, got = j_pn.fit_g_series(ps, gs, n_terms), t_pn.fit_g_series(ps, gs, n_terms)
        assert np.array_equal(ref[0], got[0]) and ref[1] == got[1]
    for om, e in ((60.0 ** -1.5, 0.04), (120.0 ** -1.5, 0.12)):
        assert t_pn.p_at_fixed_omega(om, e) == j_pn.p_at_fixed_omega(om, e)
    assert (t_pn.G0_EXACT, t_pn.G2_PUBLISHED, t_pn.G3_PUBLISHED) == (
        j_pn.G0_EXACT, j_pn.G2_PUBLISHED, j_pn.G3_PUBLISHED)


def test_torus_algebra_is_the_original():
    """`Torus` products, sums and harmonic tables, `h_of_t`,
    `fourier_family` and `fit_constant` of the multipole derivation on the
    same orbit data."""
    from tools import derive_multipoles as j_dm
    from tools import torch_derive_multipoles as t_dm

    od = j_dm.orbit_data(10.0, 0.37)
    rng = np.random.default_rng(7)
    a = {m: rng.standard_normal(t_dm.N_CHI) + 1j * rng.standard_normal(t_dm.N_CHI)
         for m in (-1, 0, 2)}
    b = {m: rng.standard_normal(t_dm.N_CHI) for m in (1, 2)}
    tabs = []
    for mod in (j_dm, t_dm):
        x, y = mod.Torus(a), mod.Torus(b)
        z = (x * y + 0.5 * x) - y * 2.0
        tabs.append(z.coeffs(od))
    assert sorted(tabs[0]) == sorted(tabs[1])
    for m in tabs[0]:
        assert np.array_equal(tabs[0][m], tabs[1][m])
    t_grid = np.linspace(0.0, 3.1 * 2 * np.pi / od["om_r"], 11)
    assert np.array_equal(t_dm.h_of_t([tabs[0]], od, t_grid, [3]),
                          j_dm.h_of_t([tabs[0]], od, t_grid, [3]))
    fr = lambda r, l: l * r**2  # noqa: E731
    assert np.array_equal(t_dm.fourier_family(od, fr, 2), j_dm.fourier_family(od, fr, 2))
    h = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    g = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    assert t_dm.fit_constant(h, g) == j_dm.fit_constant(h, g)
    assert (t_dm.N_CHI, t_dm.N_MAX) == (j_dm.N_CHI, j_dm.N_MAX)
