"""The reference, written apart from the program, agrees with it where the
model says they must agree: each piece of the model at sample points, the
flux table and the configured harmonics against what the reference's own
rules give."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import REPO

CONFIGS = os.path.join(REPO, "benchmark", "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def test_the_model_pieces_agree_with_the_programs():
    from benchmark.reference import physics as ph
    from benchmark.reference import plain
    from emri_frequencydomainwaveforms_tpu_torch.lisa.sensitivity import get_sensitivity
    from emri_frequencydomainwaveforms_tpu_torch.models import amplitude, geodesic, waveform
    from emri_frequencydomainwaveforms_tpu_torch.utils.ylm import spin_weighted_ylm

    modes, table = ph.mode_list(30, 6), amplitude.default_mode_table(30, 6)
    assert (modes.ls == table.ls).all() and (modes.ms == table.ms).all()
    assert (modes.ns == table.ns).all()
    p, e = np.array([12.0, 9.5, 7.2, 10.3]), np.array([0.35, 0.30, 0.2, 0.05])
    om_p, om_r = geodesic.fundamental_frequencies(torch.tensor(p), torch.tensor(e))
    ref_p, ref_r = ph.frequencies(p, e)
    np.testing.assert_allclose(ref_p, om_p.numpy(), rtol=1e-13)
    np.testing.assert_allclose(ref_r, om_r.numpy(), rtol=1e-13)
    # the program projects its amplitudes in float32: the strong modes agree to ~1e-6
    re, im = amplitude.mode_amplitudes(torch.tensor(p), torch.tensor(e), table, tail=True,
                                       factorized=True, rwz=True)
    a_ref = ph.amplitudes(p, e, modes)
    gap = np.linalg.norm(a_ref - (re.numpy() + 1j * im.numpy()), axis=1)
    assert (gap / np.linalg.norm(a_ref, axis=1)).max() < 1e-4
    for sign in (1, -1):
        yr, yi = spin_weighted_ylm(table.ls, sign * table.ms, torch.tensor(0.7, dtype=torch.float64),
                                   torch.tensor(0.5, dtype=torch.float64))
        y = ph.spin_weighted_ylm(modes.ls, sign * modes.ms, 0.7, 0.5)
        assert np.abs(y - (yr.numpy() + 1j * yi.numpy())).max() < 1e-13
    f = waveform.default_frequencies(1.0, 10.0)
    f = f[f > 0][::100]
    f0, df, nf = plain.positive_grid(1.0, 10.0, 100)
    assert nf == len(f) and f0 == f[0] and df == pytest.approx(f[1] - f[0], rel=1e-12)
    np.testing.assert_allclose(plain.lisa_psd(f), get_sensitivity(f, sens_fn="cornish_lisa_psd"),
                               rtol=1e-13)


def test_the_flux_table_is_the_references_own_and_near_the_programs_grid():
    from benchmark.reference import physics as ph
    from benchmark.reference import plain
    from emri_frequencydomainwaveforms_tpu_torch.models import flux

    cfg = _cfg("wfbatch_1yr_rwz")
    table = plain.flux_table(cfg)
    built = ph.FluxTable.build(plain.physics(cfg))
    assert np.array_equal(table.values, built.values)
    assert (table.u0, table.du, table.e0, table.de) == (built.u0, built.du, built.e0, built.de)
    grid = flux.build_flux_grid(tail=True, factorized=True, rwz=True, device="cpu")
    assert (grid.u0, grid.du, grid.e0, grid.de) == pytest.approx((table.u0, table.du, table.e0,
                                                                  table.de), rel=1e-15)
    rel = np.abs(grid.values.numpy() - table.values) / np.abs(table.values)
    # the program's grid carries its float32 amplitude projection
    assert np.median(rel) < 1e-5 and rel.max() < 1e-3


@pytest.mark.parametrize("name", ["wfbatch_1yr_rwz", "pe_1yr_production"])
def test_the_configured_harmonics_are_the_strongest(name):
    from benchmark.reference import plain

    cfg = _cfg(name)
    if name.startswith("wf"):
        s = cfg["representative_source"]
        args = (cfg["mass_1"], cfg["mass_2"], s["p0"], s["e0"], s["theta"], s["phi"],
                cfg["t_years"], cfg["k_max"])
        kw = {}
    else:
        i = cfg["injection"]
        args = (cfg["M"], cfg["mu"], cfg["p0"], cfg["e0"], i["qS"], i["phiS"], cfg["Tobs"],
                cfg["kmax"])
        kw = dict(phi_phi0=i["Phi_phi0"], phi_r0=i["Phi_r0"])
    assert plain.strongest_harmonics(cfg, *args, **kw) == cfg["harmonics"]
