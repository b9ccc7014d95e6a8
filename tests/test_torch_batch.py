"""A walker's PE log L does not depend on its batch: the reference's contract.

The JAX package's PE template likelihood (``cli/emri_pe.py``'s FD
template, frozen slots, whitened residual) evaluated under ``vmap`` on a
batch of 16 walkers and on each walker alone agrees to 1e-12 on the CPU:
the batch invariance the port's fixed-order row kernels restore on the card
(``ops/row_ops.py``) is the reference's own behaviour, so a walker whose
log L follows its batch is the port's fault. The port's likelihood on the
same problem, alone and in the batch, agrees to the bit. The size is the
CPU one of ``testing/batch_dependence.py`` (0.05 yr, Peters-Mathews flux,
flat amplitudes, 16 slots).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.lisa.likelihood import Likelihood as JLikelihood
from emri_frequencydomainwaveforms_tpu.lisa.sensitivity import get_sensitivity as j_sensitivity
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    fd_waveform_core as j_core,
    waveform_prologue as j_prologue,
)
from emri_frequencydomainwaveforms_tpu.utils.transform import TransformContainer as JTransform
from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe
from emri_frequencydomainwaveforms_tpu_torch.testing import batch_dependence, pe_mesh

P0 = 8.5


@pytest.fixture(scope="module")
def spec():
    return pe_mesh.pe_problem(batch_dependence.CPU_ARGS, P0, "cpu")


def _jax_likelihood(spec):
    args = emri_pe.build_parser().parse_args(spec["argv"].split())
    table_t, f_np = spec["table"], spec["f"]
    idx_t = np.arange(table_t.num_modes)
    f_arr = jnp.asarray(f_np)
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    def template(params14):
        m, mu, a, p0_, e0_, x0, dist_, qs, fs, qk, fk, pph0, pth0, pr0 = params14
        pro = j_prologue(m, mu, p0_, e0_, qs, fs, dist_, pph0, pr0, t_years=args.Tobs,
                         table=table_t, k_max=args.kmax, eps=args.eps,
                         max_steps=args.max_steps, forced_idx=idx_t,
                         **emri_pe.physics(args))
        hpr, hpi, hcr, hci = j_core(pro, table_t, f_arr, channels=True, uniform=uniform)
        return [(hpr, hpi), (hcr, hci)]

    transform = JTransform(
        parameter_transforms={(0, 1): lambda lm, le: [jnp.exp(lm), jnp.exp(lm) * jnp.exp(le)]},
        fill_dict={"ndim_full": 14,
                   "fill_values": np.array([0.0, 1.0, 1.0, np.pi / 4, np.pi / 3, np.pi / 5,
                                            np.pi / 6, 0.0]),
                   "fill_inds": np.array([2, 5, 6, 7, 8, 9, 10, 12])})
    like = JLikelihood(template, 2, f_arr=f_arr, parameter_transforms=transform)
    like.inject_signal(spec["data"], noise_fn=lambda f: np.asarray(
        j_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd")))
    return like


def test_reference_pe_log_like_does_not_depend_on_the_batch(spec):
    like = _jax_likelihood(spec)
    x = jnp.asarray(spec["x"])
    batch = np.asarray(like(x))
    assert np.all(np.isfinite(batch)) and np.all(batch < 0)
    for k in (0, 5, 15):
        alone = np.asarray(like(x[k:k + 1]))[0]
        np.testing.assert_allclose(alone, batch[k], rtol=1e-12, atol=0)


def test_port_pe_log_like_does_not_depend_on_the_batch(spec):
    like, last = pe_mesh.pe_likelihood(spec, "cpu")
    x = torch.as_tensor(spec["x"])
    batch = like(x)
    knots, template = last["n_live"], last["template"]
    for k in (0, 5, 15):
        alone = like(x[k:k + 1])
        assert float(alone[0]) == float(batch[k])
        assert int(last["n_live"][0]) == int(knots[k])
        assert torch.equal(last["template"][0], template[k])
