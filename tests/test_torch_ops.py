"""Parity of the PyTorch port's numerics substrate with the JAX package.

Same inputs (numpy, from a seed) through both implementations on the CPU:
tridiagonal solves, cubic splines, the float32 K_{1/3} SPA factor, the
spin-weighted harmonics and the physical constants. float64 stages agree to
~1e-12 relative (different reduction / libm rounding only); the float32
Bessel factor to ~1e-6.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.ops import bessel as j_bessel
from emri_frequencydomainwaveforms_tpu.ops import cubic_spline as j_spline
from emri_frequencydomainwaveforms_tpu.ops import tridiag as j_tridiag
from emri_frequencydomainwaveforms_tpu.utils import constants as j_const
from emri_frequencydomainwaveforms_tpu.utils import ylm as j_ylm
from emri_frequencydomainwaveforms_tpu_torch.ops import bessel as t_bessel
from emri_frequencydomainwaveforms_tpu_torch.ops import cubic_spline as t_spline
from emri_frequencydomainwaveforms_tpu_torch.ops import tridiag as t_tridiag
from emri_frequencydomainwaveforms_tpu_torch.utils import constants as t_const
from emri_frequencydomainwaveforms_tpu_torch.utils import ylm as t_ylm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


def test_constants_equal_reference():
    for name in j_const.__all__:
        assert getattr(t_const, name) == getattr(j_const, name), name


def test_thomas_solve_batched():
    rng = np.random.default_rng(11)
    n, batch = 29, (3, 4)
    dl = rng.standard_normal(batch + (n,))
    d = rng.standard_normal(batch + (n,)) + 6.0
    du = rng.standard_normal(batch + (n,))
    b = rng.standard_normal(batch + (n,))
    ref = j_tridiag.thomas_solve(*(jnp.asarray(x) for x in (dl, d, du, b)))
    got = t_tridiag.thomas_solve(*(torch.from_numpy(x) for x in (dl, d, du, b)))
    assert _rel(ref, got) < 1e-12


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_spline_fit_and_eval(bc):
    rng = np.random.default_rng(12)
    # jittered knots, as adaptive trajectory knots are (no near-coincident
    # pairs, which would only measure the conditioning of the solve)
    x = np.linspace(0.0, 10.0, 41) + rng.uniform(-0.05, 0.05, 41)
    y = np.stack([np.sin(x) + 0.1 * x**2, np.cos(1.3 * x) * np.exp(-0.05 * x)])
    ref = j_spline.fit_cubic_spline(jnp.asarray(x), jnp.asarray(y), bc=bc)
    got = t_spline.fit_cubic_spline(torch.from_numpy(x), torch.from_numpy(y), bc=bc)
    assert _rel(ref.c, got.c) < 1e-12
    xq = np.linspace(x[0] - 0.3, x[-1] + 0.3, 257)  # includes extrapolation
    for deriv in range(4):
        a = j_spline.spline_eval(ref, jnp.asarray(xq), deriv=deriv)
        b = t_spline.spline_eval(got, torch.from_numpy(xq), deriv=deriv)
        assert _rel(a, b) < 1e-12, deriv


def test_spline_batched_knots():
    # one knot vector per walker: (B, n) knots, (B, M, n) values
    rng = np.random.default_rng(13)
    n_b, m, n = 3, 5, 24
    x = np.linspace(0.0, 3.0, n) + rng.uniform(-0.02, 0.02, (n_b, n))
    y = rng.standard_normal((n_b, m, n))
    got = t_spline.fit_cubic_spline(
        torch.from_numpy(x)[:, None, :], torch.from_numpy(y), bc="not-a-knot"
    )
    xq = np.sort(rng.uniform(0.0, 3.0, (n_b, 17)), axis=-1)
    vals = t_spline.spline_eval(
        t_spline.CubicSplineCoeffs(torch.from_numpy(x), got.c), torch.from_numpy(xq), deriv=1
    )
    for i in range(n_b):
        ref = j_spline.fit_cubic_spline(jnp.asarray(x[i]), jnp.asarray(y[i]), bc="not-a-knot")
        assert _rel(ref.c, got.c[i]) < 1e-12
        assert _rel(j_spline.spline_eval(ref, jnp.asarray(xq[i]), deriv=1), vals[i]) < 1e-12


def test_kve_one_third_imag_float32():
    rng = np.random.default_rng(14)
    # both series branches, the switch point and the fold interior
    w = np.concatenate([
        -np.logspace(-30, 12, 400), -rng.uniform(7.5, 8.5, 64), rng.uniform(-50, 50, 64)
    ]).astype(np.float32)
    jr, ji = j_bessel.kve_one_third_imag(jnp.asarray(w))
    tr, ti = t_bessel.kve_one_third_imag(torch.from_numpy(w))
    assert tr.dtype == torch.float32
    mag = np.hypot(np.asarray(jr), np.asarray(ji))
    err = np.hypot(np.asarray(jr) - tr.numpy(), np.asarray(ji) - ti.numpy())
    assert np.max(err / mag) < 1e-6


def test_spin_weighted_ylm():
    rng = np.random.default_rng(15)
    ls = np.array([2, 2, 2, 3, 3, 4, 5, 6, 6])
    ms = np.array([2, 0, -1, 3, -2, 4, 1, 6, -5])
    theta = rng.uniform(0.0, np.pi, 6)
    phi = rng.uniform(0.0, 2 * np.pi, 6)
    jr, ji = j_ylm.spin_weighted_ylm(ls, ms, jnp.asarray(theta), jnp.asarray(phi))
    tr, ti = t_ylm.spin_weighted_ylm(ls, ms, torch.from_numpy(theta), torch.from_numpy(phi))
    assert tr.shape == (6, len(ls))
    scale = np.max(np.hypot(np.asarray(jr), np.asarray(ji)))
    assert np.max(np.abs(np.asarray(jr) - tr.numpy())) / scale < 1e-12
    assert np.max(np.abs(np.asarray(ji) - ti.numpy())) / scale < 1e-12


def test_port_imports_no_jax():
    # modules the import adds must include neither JAX nor the JAX package
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import emri_frequencydomainwaveforms_tpu_torch\n"
        "import emri_frequencydomainwaveforms_tpu_torch.convert\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.waveform\n"
        "import emri_frequencydomainwaveforms_tpu_torch.ops.fd_dense\n"
        "import emri_frequencydomainwaveforms_tpu_torch.ops.interp2d\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.tail\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.rho\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.rwz_calibration\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models._rwz_calibration_data\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models._rwz_ecc_data\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.amplitude_backends\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.flux\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.inspiral\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.summation_fd\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.summation_td\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.windows\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.fdutils\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.transform\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.periodic\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.sensitivity\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.noise\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.diagnostic\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.ensemble\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.backends.hdf\n"
        "import emri_frequencydomainwaveforms_tpu_torch.cli.emri_pe\n"
        "import emri_frequencydomainwaveforms_tpu_torch.cli.check_mode_by_mode\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.trajectory_quad\n"
        "import emri_frequencydomainwaveforms_tpu_torch.models.utility\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.stopping\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.gaussian\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.distgen\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.group\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.mt\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.gb\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.tree\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.rj\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.moves.tempering\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.state\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.guide\n"
        "import emri_frequencydomainwaveforms_tpu_torch.inference.pipeline\n"
        "import emri_frequencydomainwaveforms_tpu_torch.testing.batch_dependence\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.tdi\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.mldc\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa\n"
        "import emri_frequencydomainwaveforms_tpu_torch.lisa.relbin\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.autocorr\n"
        "import emri_frequencydomainwaveforms_tpu_torch.utils.plotting\n"
        "import emri_frequencydomainwaveforms_tpu_torch.parallel\n"
        "import emri_frequencydomainwaveforms_tpu_torch.parallel.mesh\n"
        "import emri_frequencydomainwaveforms_tpu_torch.graft_entry\n"
        "import emri_frequencydomainwaveforms_tpu_torch.ops.row_ops\n"
        "import emri_frequencydomainwaveforms_tpu_torch.ops.dp5_inspiral\n"
        "import emri_frequencydomainwaveforms_tpu_torch.ops.cuda_build\n"
        "import emri_frequencydomainwaveforms_tpu_torch.testing.pe_mesh\n"
        "import emri_frequencydomainwaveforms_tpu_torch.testing.mesh_cases\n"
        "import emri_frequencydomainwaveforms_tpu_torch.testing.truth\n"
        "import emri_frequencydomainwaveforms_tpu_torch.testing.truth_cases\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'emri_frequencydomainwaveforms_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or 'jax' in before\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parents[1]),
    )
    assert res.returncode == 0, res.stderr


def test_port_and_smoke_sources_name_no_jax_import():
    # no line of the port's sources, of chip_smoke.py or of the port's
    # examples imports JAX or the JAX package, at module level or inside a
    # function
    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|emri_frequencydomainwaveforms_tpu)(\s|\.|$)")
    files = sorted((root / "emri_frequencydomainwaveforms_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    examples = sorted((root / "examples").glob("torch_*.py"))
    assert len(examples) == 3
    files += examples
    assert len(files) > 30
    bad = [f"{f.relative_to(root)}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines()) if pattern.match(line)]
    assert not bad, bad
