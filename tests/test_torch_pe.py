"""The PyTorch port's parameter-estimation path against the JAX package.

The likelihood of tests/test_pe_end_to_end.py's configuration through both
packages; `run_emri_pe` at a tiny configuration on the CPU with the
in-memory backend, its walker start held to the JAX CLI's; and proposals
outside the prior, which the port does not evaluate, giving what the
reference's masked form gives. Tolerances are stated per test.
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.cli import emri_pe as j_cli
from emri_frequencydomainwaveforms_tpu.inference import prior as j_prior
from emri_frequencydomainwaveforms_tpu.inference.moves import stretch as j_stretch
from emri_frequencydomainwaveforms_tpu.lisa.likelihood import Likelihood as JLikelihood
from emri_frequencydomainwaveforms_tpu.lisa.sensitivity import get_sensitivity
from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu_torch import convert
from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe as t_cli
from emri_frequencydomainwaveforms_tpu_torch.inference import prior as t_prior
from emri_frequencydomainwaveforms_tpu_torch.inference.backends.memory import Backend
from emri_frequencydomainwaveforms_tpu_torch.inference.moves import stretch as t_stretch
from emri_frequencydomainwaveforms_tpu_torch.lisa.likelihood import Likelihood as TLikelihood
from emri_frequencydomainwaveforms_tpu_torch.models import integrate as t_int
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.models.flux import inspiral_rhs, pn_flux_e_l, stop_condition
from test_torch_inference import _jax_stretch_draws

# tests/test_pe_end_to_end.py's configuration
T_YEARS, DT = 0.02, 10.0
M_TRUE, MU_TRUE = 1e6, 50.0
P0_TRUE, E0_TRUE = 9.2, 0.3
TRUTH = np.array([P0_TRUE, E0_TRUE])
KEY = 0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noise(f):
    return np.asarray(get_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd"))


@pytest.fixture(scope="module")
def pe_setup():
    """Both packages' likelihoods over (p0, e0) on the injection."""
    table = default_mode_table(8, l_max=2)
    freq = j_wf.default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0][::20]
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))
    kw = dict(t_years=T_YEARS, k_max=16, eps=1e-2, max_steps=128)

    def j_template(params):
        pro = j_wf.waveform_prologue(M_TRUE, MU_TRUE, params[0], params[1], 0.7, 0.5, 1.0, 1.0,
                                     2.0, table=table, **kw)
        hpr, hpi, hcr, hci = j_wf.fd_waveform_core(pro, table, jnp.asarray(f_np), channels=True,
                                                   uniform=uniform)
        return [(hpr, hpi), (hcr, hci)]

    t_table = convert.mode_table_from_numpy(*table)

    def t_template(params):
        pro = t_wf.waveform_prologue(M_TRUE, MU_TRUE, params[:, 0], params[:, 1], 0.7, 0.5, 1.0,
                                     1.0, 2.0, table=t_table, device="cpu", **kw)
        hpr, hpi, hcr, hci = t_wf.fd_waveform_core(pro, t_table, len(f_np), channels=True,
                                                   uniform=uniform)
        return [(hpr, hpi), (hcr, hci)]

    like_j = JLikelihood(j_template, 2, f_arr=jnp.asarray(f_np))
    chans = jax.jit(j_template)(jnp.asarray(TRUTH))
    data = [np.asarray(c[0]) + 1j * np.asarray(c[1]) for c in chans]
    like_j.inject_signal(data, noise_fn=_noise)
    like_t = TLikelihood(t_template, 2, f_arr=f_np, device="cpu")
    like_t.inject_signal([c for c in data], noise_fn=_noise)
    return like_j, like_t


def test_likelihood_matches_reference(pe_setup):
    like_j, like_t = pe_setup
    # zero residual at the injection, as the reference's test asserts
    assert abs(float(like_t(TRUTH[None])[0])) < 1e-3
    # a perturbed 4-walker batch: |dlogL| <= 1e-3 max(1, |logL|) (float32
    # spectra in both packages; the trajectories agree to ~1e-12)
    walkers = TRUTH + np.random.default_rng(7).normal(0, [2e-5, 1e-5], (4, 2))
    ref = np.asarray(like_j(jnp.asarray(walkers)))
    got = like_t(walkers).numpy()
    assert ref.min() < -1.0  # the perturbation is seen
    np.testing.assert_array_less(np.abs(got - ref), 1e-3 * np.maximum(1.0, np.abs(ref)))


def test_out_of_prior_proposals_match_the_reference(pe_setup):
    # the JAX move on its own draws evaluates every proposal, those outside
    # the prior (e0 <= 0, p0 below the separatrix) included, and discards
    # their value; the port, fed the same draws, evaluates only the ones
    # inside. Coordinates, log-priors and accept counts identical; log L as
    # in test_likelihood_matches_reference, |dlogL| <= 1e-3 max(1, |logL|),
    # and -1e300 on the same walkers
    like_j, like_t = pe_setup
    bounds = {0: (6.0, 12.0), 1: (0.001, 0.7)}
    pj = j_prior.ProbDistContainer({k: j_prior.uniform_dist(*b) for k, b in bounds.items()})
    pt = t_prior.ProbDistContainer({k: t_prior.uniform_dist(*b) for k, b in bounds.items()})
    ntemps, nwalkers = 2, 6
    rng = np.random.default_rng(3)
    coords = TRUTH + rng.normal(0, [2e-5, 1e-5], (ntemps, nwalkers, 2))
    # partners far away: their stretches leave the prior
    coords[:, 3:] = [[3.0, -0.2], [9.2, 0.3 - 1e-5], [5.5, 0.5]]
    lp0 = np.array(pj.logpdf(jnp.asarray(coords)))
    ll0 = np.where(np.isfinite(lp0),
                   np.asarray(like_j(jnp.asarray(coords.reshape(-1, 2)))).reshape(ntemps, nwalkers),
                   -1e300)
    betas = np.array([1.0, 0.5])
    key = jax.random.PRNGKey(KEY)
    ref = [np.asarray(v) for v in j_stretch.StretchMove(a=2.0).propose(
        key, *(jnp.asarray(v) for v in (coords, ll0, lp0, betas)), pj.logpdf, like_j)]

    rows = []

    def logl(x):
        rows.append(x.shape[0])
        return like_t(x)

    c, ll, lp = (torch.from_numpy(v) for v in (coords, ll0, lp0))
    acc = torch.zeros((ntemps,), dtype=torch.int64)
    for half, (z, partner, u) in enumerate(_jax_stretch_draws(key, ntemps, nwalkers // 2, 2.0)):
        c, ll, lp, a_h = t_stretch.stretch_half(c, ll, lp, torch.from_numpy(betas), half, z,
                                                partner, u, pt.logpdf, logl)
        acc = acc + a_h
    np.testing.assert_array_equal(c.numpy(), ref[0])
    np.testing.assert_array_equal(lp.numpy(), ref[2])
    np.testing.assert_array_equal(acc.numpy(), ref[3])
    ll = ll.numpy()
    np.testing.assert_array_equal(ll == -1e300, ref[1] == -1e300)
    np.testing.assert_array_less(np.abs(ll - ref[1]), 1e-3 * np.maximum(1.0, np.abs(ref[1])))
    # some proposals left the prior and did not reach the port's likelihood
    assert sum(rows) < ntemps * nwalkers and ref[3].sum() > 0


def test_trajectory_stops_lanes_that_cannot_start():
    # a lane below the separatrix has a non-finite rate at its first knot:
    # it keeps one knot and costs the batch no iterations (the batch takes
    # exactly the right-hand-side calls of its good lane alone)
    nu = 10.0 / 1e6
    calls = []

    def rhs(y):
        calls.append(1)
        return inspiral_rhs(y, nu, pn_flux_e_l)

    def run(y0):
        calls.clear()
        knots = t_int.integrate_inspiral(rhs, lambda y: stop_condition(y, 0.12),
                                         torch.tensor(y0, dtype=torch.float64), 2e4, max_steps=64)
        return knots, len(calls)

    good = [11.0, 0.3, 0.0, 0.0]
    alone, n_alone = run([good])
    batch, n_batch = run([good, [5.0, 0.3, 0.0, 0.0], [7.0, 0.7, 0.0, 0.0]])
    assert n_batch == n_alone
    assert batch.n.tolist() == [int(alone.n[0]), 1, 1]
    np.testing.assert_array_equal(batch.t[0].numpy(), alone.t[0].numpy())
    np.testing.assert_array_equal(batch.y[0].numpy(), alone.y[0].numpy())


def _cli_args(pkg):
    argv = ("-Tobs 0.02 -M 1e6 -mu 10 -e0 0.35 -dt 10 -downsample 20 -nwalkers 4 -ntemps 2 "
            "-nsteps 2 -flux pm -amp flat -kmax 16 -max_steps 128").split()
    return pkg.build_parser().parse_args(argv)


def test_run_emri_pe_tiny_on_cpu():
    args = _cli_args(t_cli)
    out = t_cli.run_emri_pe(args, backend=Backend(), device="cpu")
    chain = out["chain"]
    assert chain.shape == (2, 2, 4, 1, 6) and np.isfinite(chain).all()
    ll = out["backend"].get_log_like()
    assert ll.shape == (2, 2, 4) and np.isfinite(ll).all() and (ll > -1e300).all()
    acc = out["backend"].acceptance_fraction
    assert ((acc >= 0) & (acc <= 1)).all() and np.isfinite(out["snr"])
    assert abs(float(out["likelihood"](out["truth"][None])[0])) < 1e-3

    # the walker start is the JAX CLI's: the same numpy draws around the
    # truth. The truth's p0 comes from each package's duration solve (the
    # JAX CLI's call is rebuilt here with its arguments); the two bisections
    # agree to 1e-8 relative, their last decisions near the root differ
    jargs = _cli_args(j_cli)
    assert vars(args) == vars(jargs)  # the same flags and defaults
    p0 = float(j_insp.get_p_at_t(jargs.M, jargs.mu, jargs.e0, 0.99 * jargs.Tobs, flux=jargs.flux))
    assert abs(out["p0"] / p0 - 1.0) < 1e-8

    def start_of(p0_):
        truth = np.array([np.log(jargs.M), np.log(jargs.mu / jargs.M), p0_, jargs.e0, 1.0, 2.0])
        rng = np.random.default_rng(jargs.seed)
        scales = np.abs(truth) * jargs.start_scale + 1e-9
        return truth, truth[None, None, :] + rng.normal(
            0, 1.0, (jargs.ntemps, jargs.nwalkers, 6)) * scales[None, None, :]

    truth, start = start_of(out["p0"])
    np.testing.assert_array_equal(out["truth"], truth)
    np.testing.assert_array_equal(out["start"], start)
    np.testing.assert_allclose(out["start"], start_of(p0)[1], rtol=1e-8, atol=0)


@pytest.mark.parametrize("template,inject_fd", [("td", 1), ("fd", 0)])
def test_run_emri_pe_td_template_and_td_injection(monkeypatch, template, inject_fd):
    # the TD template (dense TD sum, DFT at the analysis bins) and the TD
    # injection (the facade, Hann-windowed FFT) through run_emri_pe; the
    # duration solve is replaced by its result for this configuration
    from emri_frequencydomainwaveforms_tpu_torch.models import inspiral

    monkeypatch.setattr(inspiral, "get_p_at_t",
                        lambda *a, **k: torch.tensor([7.047850297825895], dtype=torch.float64))
    argv = ("-Tobs 0.02 -M 1e6 -mu 10 -e0 0.35 -dt 10 -downsample 20 -nwalkers 4 -ntemps 2 "
            f"-nsteps 2 -flux pm -amp flat -kmax 16 -max_steps 128 -template {template} "
            f"-injectFD {inject_fd} -window_flag 1").split()
    out = t_cli.run_emri_pe(t_cli.build_parser().parse_args(argv), backend=Backend(),
                            device="cpu")
    assert out["chain"].shape == (2, 2, 4, 1, 6) and np.isfinite(out["chain"]).all()
    ll = out["backend"].get_log_like()
    assert np.isfinite(ll).all() and (ll > -1e300).all() and np.isfinite(out["snr"])
    ll_truth = float(out["likelihood"](out["truth"][None])[0])
    if inject_fd:
        assert abs(ll_truth) < 1e-3  # the template is the injection
    else:
        # the TD injection (detector-frame facade, its own eps selection,
        # windowed) differs from the FD template, as in the reference
        assert -1e4 < ll_truth < -1.0


def test_template_rows_do_not_depend_on_their_batch_on_the_cpu(capsys):
    # testing/batch_dependence.py on the CPU: every stage of the template
    # (one RHS evaluation and its tangent, the dp5 trajectory, amplitudes,
    # Ylm, splines, level-1 tables, dense pass, likelihood sum, the whole
    # template and log L) and every fixed-order row kernel gives walkers 0
    # and 5 the same row alone and in batches of 2, 4, 8 and 16, to the bit
    from emri_frequencydomainwaveforms_tpu_torch.testing import batch_dependence

    assert batch_dependence.main(["cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[batch] ") and " worst " in ln and "(informational)" not in ln]
    assert len(lines) == 18
    for ln in lines:
        assert "worst 0.000e+00 (bit-exact;" in ln, ln
        assert re.search(r"\[0@1 .*5@16 ", ln), ln
