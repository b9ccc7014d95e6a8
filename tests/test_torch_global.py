"""The PyTorch port's grouped likelihood, branch side-car, sampler presets
and staged pipeline against the JAX package.

`GlobalLikelihood` runs both packages' carried templates (plain arithmetic,
so both compute the same template values) on groups of one row, of several
rows and with an empty group, whole and in ``subset`` chunks: log L within
1e-12 relative. `BranchSupplimental` moves the same numpy data. The
presets build the sampler the reference builds and run it; the pipeline
runs the reference's search -> PE -> residual test at its size.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import guide as j_guide
from emri_frequencydomainwaveforms_tpu.inference.state import BranchSupplimental as JSupp
from emri_frequencydomainwaveforms_tpu.lisa import likelihood as j_like
from emri_frequencydomainwaveforms_tpu.utils.transform import TransformContainer as JTransform
from emri_frequencydomainwaveforms_tpu_torch.inference import (
    BranchSupplimental,
    InfoManager,
    PipelineGuide,
    PipelineModule,
    ResidualUpdateModule,
    SamplerModule,
    make_state,
)
from emri_frequencydomainwaveforms_tpu_torch.inference.guide import (
    EMRIGuide,
    GBGuide,
    MBHGuide,
    SamplerGuide,
)
from emri_frequencydomainwaveforms_tpu_torch.inference.prior import ProbDistContainer, uniform_dist
from emri_frequencydomainwaveforms_tpu_torch.lisa import GlobalLikelihood, Likelihood
from emri_frequencydomainwaveforms_tpu_torch.lisa.relbin import RelativeBinningLikelihood
from emri_frequencydomainwaveforms_tpu_torch.utils.transform import TransformContainer

F = np.linspace(1e-4, 5e-3, 200)
X = F * 1e3


def _noise(f):
    return 1e-2 * (1.0 + (np.asarray(f) / 1e-3) ** -2)


def _j_template(p):
    """One walker (ndim,) -> two (re, im) channels (the JAX contract)."""
    x = jnp.asarray(X)
    return [(p[0] * x + p[1] * x**2, p[1] - p[0] * x**3), (p[0] - p[1] * x, p[0] * p[1] * x)]


def _t_template(p):
    """(n, ndim) walkers -> two (re, im) channels of (n, nf) (the port's)."""
    x = torch.from_numpy(X)[None]
    a, b = p[:, :1], p[:, 1:2]
    return [(a * x + b * x**2, b - a * x**3), (a - b * x, a * b * x)]


TRUTH = np.array([0.8, -0.3])


def _data():
    x = X
    a, b = TRUTH
    return [(a * x + b * x**2) + 1j * (b - a * x**3), (a - b * x) + 1j * (a * b * x)]


def _pair(transform=False, subset=None):
    tj = JTransform({0: jnp.exp}) if transform else None
    tt = TransformContainer({0: torch.exp}) if transform else None
    gj = j_like.GlobalLikelihood(_j_template, 2, f_arr=F, parameter_transforms=tj)
    gt = GlobalLikelihood(_t_template, 2, f_arr=F, parameter_transforms=tt, subset=subset,
                          device="cpu")
    gj.inject_signal(_data(), noise_fn=_noise)
    gt.inject_signal(_data(), noise_fn=_noise)
    return gj, gt


# rows per group: one each; several with a middle group empty; one group
GROUPS = {"single": [0, 1, 2, 3, 4, 5, 6], "several": [0, 0, 2, 2, 2, 3, 3],
          "one_group": [0, 0, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("subset", [None, 3])
def test_global_likelihood_against_jax(groups, subset):
    # log L per group within 1e-12 relative; chunked as whole; an empty
    # group gets the data's own log L
    params = TRUTH + np.random.default_rng(5).normal(0, 0.1, (7, 2))
    gj, gt = _pair(subset=subset)
    g = np.array(GROUPS[groups])
    ref = np.asarray(gj.get_ll(jnp.asarray(params), groups=jnp.asarray(g)))
    got = gt.get_ll(params, groups=g)
    assert got.dtype == torch.float64 and got.shape == (g.max() + 1,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)
    if groups == "several":
        empty = gt.get_ll(np.zeros((1, 2)), groups=[0])
        np.testing.assert_allclose(got[1].numpy(), empty.numpy(), rtol=1e-12)
    if groups == "single":
        # one row per group: the per-row likelihood's values
        np.testing.assert_allclose(got.numpy(), gt(params).numpy(), rtol=1e-13, atol=0)
    _, whole = _pair()
    np.testing.assert_allclose(got.numpy(), whole.get_ll(params, groups=g).numpy(), rtol=1e-14)


def test_global_likelihood_transform_and_no_groups():
    # a parameter transform (exp of the first column, 1e-12), the zero
    # residual at the injection, and get_ll without groups as the per-row
    # log L
    params = np.array([[np.log(0.8), -0.3], [np.log(0.5), 0.1], [np.log(1.2), -0.6]])
    gj, gt = _pair(transform=True, subset=2)
    ref = np.asarray(gj.get_ll(jnp.asarray(params), groups=jnp.asarray([0, 1, 1])))
    np.testing.assert_allclose(gt.get_ll(params, groups=[0, 1, 1]).numpy(), ref, rtol=1e-12)
    assert abs(float(gt.get_ll(params[:1], groups=[0])[0])) < 1e-20
    # (the first row is the injection: its log L is rounding noise, ~1e-29)
    np.testing.assert_allclose(gt.get_ll(params).numpy(), np.asarray(gj.get_ll(jnp.asarray(params))),
                               rtol=1e-12, atol=1e-20)
    assert isinstance(gt, Likelihood)
    with pytest.raises(RuntimeError, match="inject_signal"):
        GlobalLikelihood(_t_template, 2, f_arr=F, device="cpu").get_ll(params, groups=[0, 0, 1])


def test_branch_supplimental():
    # tests/test_inference.py's side-car: take / put along the walker axis
    rng = np.random.default_rng(2)
    info = {"snr": rng.normal(size=(2, 5, 3)), "tag": np.arange(30).reshape(2, 5, 3)}
    sj = JSupp({k: v.copy() for k, v in info.items()})
    st = BranchSupplimental({k: v.copy() for k, v in info.items()})
    idx = rng.integers(0, 5, (2, 5))
    for k in info:
        np.testing.assert_array_equal(st.take_along_axis(idx, 1)[k], sj.take_along_axis(idx, 1)[k])
    vals = {k: v[:, :2] * 2 for k, v in info.items()}
    put = np.array([[4, 1], [0, 3]])
    sj.put_along_axis(put, vals, 1)
    st.put_along_axis(put, vals, 1)
    for k in info:
        np.testing.assert_array_equal(st[k], sj[k])
    np.testing.assert_array_equal(st["tag"][0, 4], info["tag"][0, 0] * 2)


# ---- the presets (tests/test_inference.py::TestSamplerGuides) ----

EMRI_CENTER = [13.5, -11.0, 12.0, 0.3, 1.0, 2.0]


def test_emri_guide_builds_and_runs():
    # tests/test_inference.py::TestSamplerGuides::test_emri_guide_builds_and_runs
    def like(x):
        return -0.5 * torch.sum((x - torch.tensor(EMRI_CENTER, dtype=torch.float64)) ** 2, dim=-1)

    g = EMRIGuide(like, p0_center=12.0, nwalkers=8, ntemps=2)
    gj = j_guide.EMRIGuide(lambda x: x[..., 0], p0_center=12.0, nwalkers=8, ntemps=2)
    ens = g.build()
    ej = gj.build()
    np.testing.assert_array_equal(ens.temperature_control.betas.numpy(),
                                  np.asarray(ej.temperature_control.betas))
    np.testing.assert_array_equal(ens.periodic_vec.numpy(), np.asarray(ej.periodic_vec))
    assert ens.branch_names == ej.branch_names == ["emri"] and not ens.multibranch
    start = g.start_from_ball(EMRI_CENTER, rel_scale=1e-3)
    np.testing.assert_array_equal(start.numpy(),
                                  np.asarray(gj.start_from_ball(EMRI_CENTER, rel_scale=1e-3)))
    last = ens.run_mcmc(start, 5)
    assert torch.isfinite(last.log_like).all() and ens.backend.iteration == 5


def test_gb_guide_rj_configuration():
    # tests/test_inference.py::TestSamplerGuides::test_gb_guide_rj_configuration
    def gb_like(coords, inds):
        amp = torch.exp(coords[..., 0])
        return -0.5 * torch.sum(torch.where(inds, (amp * 1e22) ** 2, 0.0), dim=-1)

    g = GBGuide(gb_like, nleaves_max=4, nwalkers=8, ntemps=2)
    ens = g.build()
    ej = j_guide.GBGuide(gb_like, nleaves_max=4, nwalkers=8, ntemps=2).build()
    assert ens.multibranch and ens.has_reversible_jump
    assert [type(m).__name__ for m in ens.moves + ens.rj_moves] == [
        type(m).__name__ for m in ej.moves + ej.rj_moves] == ["TreeStretchMove",
                                                               "DistributionGenerateRJ"]
    assert ens.nleaves_max == ej.nleaves_max == {"gb": 4}
    inds = np.zeros((2, 8, 4), bool)
    inds[:, :, 0] = True
    state = make_state({"gb": g.priors.rvs(size=(2, 8, 4), random_state=1)}, inds={"gb": inds})
    last = ens.run_mcmc(state, 4)
    nl = last.branches["gb"].nleaves
    assert int(nl.min()) >= 0 and int(nl.max()) <= 4
    # one leaf: the flat sampler
    assert not GBGuide(gb_like, nwalkers=8).build().multibranch


def test_mbh_guide_transforms_and_relbin():
    # tests/test_inference.py::TestSamplerGuides::test_mbh_guide_transforms,
    # and the relative-binning hand-off on the port's RelativeBinningLikelihood
    g = MBHGuide(lambda x: torch.zeros(x.shape[0], dtype=torch.float64), Tobs=1.0, nwalkers=8)
    assert g.priors.ndim == 11
    tf, tfj = MBHGuide.parameter_transforms(), j_guide.MBHGuide.parameter_transforms()
    m1, m2 = tf[(0, 1)](np.log(1e6), 0.5)
    np.testing.assert_allclose(float(m1) + float(m2), 1e6, rtol=1e-12)
    np.testing.assert_allclose(float(m2) / float(m1), 0.5, rtol=1e-12)
    for got, ref in zip(tf[(0, 1)](np.log(1e6), 0.5), tfj[(0, 1)](np.log(1e6), 0.5)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-15)
    x = torch.tensor([0.3, -0.7], dtype=torch.float64)
    for k in (4, 7, 9):
        np.testing.assert_allclose(tf[k](x).numpy(), np.asarray(tfj[k](jnp.asarray(x.numpy()))),
                                   rtol=1e-15)
    f = np.linspace(1e-4, 1e-2, 400)
    h0 = [np.exp(2j * np.pi * f * 100.0)]
    like = MBHGuide.relbin_likelihood(
        lambda p, ff: [(torch.cos(2 * np.pi * ff * p[..., :1] * 100.0),
                        torch.sin(2 * np.pi * ff * p[..., :1] * 100.0))],
        f, h0, h0, np.ones_like(f), max_bins=32, device="cpu")
    assert isinstance(like, RelativeBinningLikelihood)


def test_sampler_guide_hdf_backend(tmp_path):
    # a file name makes an HDF chain backend
    priors = ProbDistContainer({0: uniform_dist(-5, 5), 1: uniform_dist(-5, 5)})
    g = SamplerGuide(lambda x: -0.5 * torch.sum(x**2, dim=-1), priors, nwalkers=8,
                     fp=str(tmp_path / "chain.h5"), seed=3)
    ens = g.build()
    ens.run_mcmc(g.start_from_ball([0.1, 0.2], rel_scale=1e-2), 3)
    assert ens.backend.iteration == 3 and (tmp_path / "chain.h5").exists()


# ---- the staged pipeline (tests/test_inference.py::TestPipeline) ----

F_GRID = np.linspace(1e-3, 1e-2, 128)


def _template_np(params):
    a, c = params
    bump = a * np.exp(-((F_GRID - c) ** 2) / (2 * 1e-7))
    return [bump + 0j, 0.5 * bump + 0j]


def _make_like(data):
    d0 = torch.from_numpy(np.real(data[0]))
    d1 = torch.from_numpy(np.real(data[1]))
    f = torch.from_numpy(F_GRID)

    def like(x):
        bump = x[..., :1] * torch.exp(-((f - x[..., 1:2]) ** 2) / (2 * 1e-7))
        return -0.5 * (torch.sum((d0 - bump) ** 2, dim=-1)
                       + torch.sum((d1 - 0.5 * bump) ** 2, dim=-1))

    return like


def test_search_then_pe_with_residual():
    # tests/test_inference.py::TestPipeline::test_search_then_pe_with_residual
    truth = np.array([3.0, 5e-3])
    data = _template_np(truth)
    info = InfoManager(name="toy", data=data, fd=F_GRID)
    assert info.nchannels == 2 and info.data_length == 128
    priors = ProbDistContainer({0: uniform_dist(0.1, 10.0), 1: uniform_dist(2e-3, 8e-3)})
    search = SamplerModule(SamplerGuide(_make_like(data), priors, nwalkers=16, ntemps=2, seed=3),
                           nsteps=40, burn=10, name="search", publish_best="best_point")
    pe = SamplerModule(SamplerGuide(_make_like(data), priors, nwalkers=16, ntemps=1, seed=4),
                       nsteps=30, burn=5, name="pe", seed_from="best_point",
                       publish_best="pe_point")
    subtract = ResidualUpdateModule(_template_np, best_attr="pe_point", name="subtract")
    PipelineGuide(info, [search, pe, subtract]).run(verbose=False)
    assert abs(info.pe_point[1] - truth[1]) < 5e-4
    assert np.abs(np.real(info.data[0])).max() < 0.2 * truth[0]
    assert hasattr(info, "best_point_loglike")


def test_sampler_module_stopping_snr(capsys):
    # the search stage's SNR stop ends the run at the first iteration whose
    # best log L reaches -snr^2 / 2; the guide's verbose labels
    priors = ProbDistContainer({0: uniform_dist(-1, 1)})
    guide = SamplerGuide(lambda x: torch.zeros(x.shape[0], dtype=torch.float64), priors,
                         nwalkers=8, seed=1)
    module = SamplerModule(guide, nsteps=20, stopping_snr=5.0, name="search")
    info = InfoManager(name="stop", data=[np.zeros(4)])
    PipelineGuide(info, [module]).run(verbose=True)
    assert module.sampler.backend.iteration == 1
    assert np.isfinite(info.best_point).all() and info.best_point_loglike == 0.0
    out = capsys.readouterr().out
    assert "starting module 0: search" in out and "finished module 0: search" in out
    assert issubclass(SamplerModule, PipelineModule)
