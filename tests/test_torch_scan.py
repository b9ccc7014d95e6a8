"""The PyTorch port's TD-vs-FD scan CLI (``cli/check_mode_by_mode.py``),
against the JAX package's.

Both packages' ``run_check`` run on the CPU with the same seed at a small
size (``-Tobs 0.02 -nsteps 2 -dt 10 -downsample 20 -flux pm -amp flat``,
and one point with ``-random_modes 1 --seed 2``, whose draw keeps the mode
(2, 2, 2)), each writing its HDF5 file.

The duration solve is the only part run apart. The port's own p0 for each
draw of the main scan is compared with the reference's to 1e-8 relative (measured 3.6e-9 and
1.2e-9), not 1e-9: the bisection decides on the DP5 duration, whose landing
on the stop surface is resolved to 1e-9 of the solve's 8-yr horizon
(`models.integrate`'s smallest step), and the two packages' step sequences
differ by a step or two, so at a 0.02-yr duration their p0 differ by a few
1e-9. The reference's p0 is then carried into the port's scan, so both scans
see the same sources and ``list_injections`` is identical.

Tolerances. SNR 2e-6 relative; every window's mismatch and the
log-likelihood 5e-4 relative. Where the two packages' trajectories take the
same DP5 steps (point 1) they agree to ~1e-8 and ~1e-6; point 0 plunges
with one step more in the port than in the reference (145 knots against
144), which moves its last knot by ~1e-3 s and gives 9.6e-7 (SNR) and up to
3.0e-4 (mismatch, on values of ~5e-4) and 2.4e-4 (log L).
"""

import h5py
import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu.cli import check_mode_by_mode as j_cli
from emri_frequencydomainwaveforms_tpu_torch.cli import check_mode_by_mode as t_cli
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp

ARGS = "-Tobs 0.02 -nsteps 2 -dt 10 -downsample 20 -flux pm -amp flat"
MODES_ARGS = ("-Tobs 0.02 -nsteps 1 -dt 10 -downsample 20 -flux pm -amp flat -random_modes 1 "
              "--seed 2")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Both packages' scans and files; the port's own p0 per draw."""
    out = tmp_path_factory.mktemp("scan")
    own_solve = t_insp.get_p_at_t
    res = {}
    for name, argv in (("main", ARGS), ("modes", MODES_ARGS)):
        j_path, t_path = str(out / f"jax_{name}.h5"), str(out / f"torch_{name}.h5")
        res["jax", name] = j_cli.run_check(j_cli.build_parser().parse_args(
            argv.split() + ["-outname", j_path]))
        res["jax_file", name] = j_path
        ref_p0 = iter([row[3] for row in res["jax", name]["list_injections"]])
        own = []

        def carried_p0(mass_1, mass_2, e0, t_out_years, **kw):
            if name == "main":  # each draw's own solve
                own.append(float(own_solve(mass_1, mass_2, e0, t_out_years, **kw)[0]))
            return torch.tensor([next(ref_p0)], dtype=torch.float64)

        t_insp.get_p_at_t = carried_p0
        try:
            res["torch", name] = t_cli.run_check(
                t_cli.build_parser().parse_args(argv.split() + ["-outname", t_path]), device="cpu")
        finally:
            t_insp.get_p_at_t = own_solve
        res["torch_file", name] = t_path
        res["own_p0", name] = own
    return res


@pytest.mark.parametrize("name", ["main", "modes"])
def test_injections_and_failures(scans, name):
    ref, got = scans["jax", name], scans["torch", name]
    assert len(ref["list_injections"]) == (2 if name == "main" else 1)
    assert got["list_injections"] == ref["list_injections"]
    assert got["failed_points"] == ref["failed_points"] == []
    for key in ("T", "dt", "eps"):
        assert got[key] == ref[key]


def test_own_duration_solve(scans):
    ref_p0 = [row[3] for row in scans["jax", "main"]["list_injections"]]
    own = scans["own_p0", "main"]
    assert len(own) == len(ref_p0) == 2
    np.testing.assert_allclose(own, ref_p0, rtol=1e-8, atol=0)


@pytest.mark.parametrize("name", ["main", "modes"])
def test_snr_mismatch_loglike(scans, name):
    ref, got = scans["jax", name], scans["torch", name]
    np.testing.assert_allclose(got["SNR"], ref["SNR"], rtol=2e-6, atol=0)
    np.testing.assert_allclose(got["loglike"], ref["loglike"], rtol=5e-4, atol=0)
    assert sorted(got["mismatch"]) == sorted(ref["mismatch"]) == sorted(j_cli.WINDOWS)
    for w in j_cli.WINDOWS:
        assert np.all(np.isfinite(got["mismatch"][w]))
        np.testing.assert_allclose(got["mismatch"][w], ref["mismatch"][w], rtol=5e-4, atol=0)
    for key in ("timing_fd", "timing_fd_downsampled", "timing_td"):
        assert len(got[key]) == len(ref[key]) and all(t > 0 for t in got[key])


def _layout(path):
    """Every attr, dataset and group of an HDF5 file: name -> (dtype, shape)."""
    items = {}
    with h5py.File(path, "r") as f:
        for key, val in f.attrs.items():
            items["attr " + key] = (np.asarray(val).dtype, np.asarray(val).shape)
        f.visititems(lambda k, obj: items.__setitem__(
            k, (obj.dtype, obj.shape) if isinstance(obj, h5py.Dataset) else "group"))
    return items


@pytest.mark.parametrize("name", ["main", "modes"])
def test_hdf5_layout(scans, name):
    ref = _layout(scans["jax_file", name])
    got = _layout(scans["torch_file", name])
    assert got == ref
    with h5py.File(scans["torch_file", name], "r") as f:
        np.testing.assert_array_equal(f["list_injections"][()],
                                      np.asarray(scans["jax", name]["list_injections"]))
        assert f.attrs["T"] == 0.02


def test_write_false_touches_no_file(tmp_path, monkeypatch):
    # run_check(write=False) returns the results and writes nothing: one
    # draw whose duration solve fails is recorded, not raised
    def fail(*a, **k):
        raise RuntimeError("duration solve failed")

    monkeypatch.setattr(t_insp, "get_p_at_t", fail)
    out = tmp_path / "none.h5"
    res = t_cli.run_check(t_cli.build_parser().parse_args(
        ARGS.split() + ["-nsteps", "1", "-outname", str(out)]), device="cpu", write=False)
    assert not out.exists()
    assert len(res["failed_points"]) == 1 and res["list_injections"] == []
