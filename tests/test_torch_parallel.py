"""The PyTorch port's walker and frequency sharding on 4 CPU ranks.

The ranks are ``torch.distributed`` processes on the ``gloo`` backend, met
through a ``FileStore`` (`parallel.mesh.run_ranks`), each with one CPU
thread. One spawn runs every mirrored case (`testing/mesh_cases.py`); a
second runs `dryrun_multichip(4)`. The PE likelihood by frequency shards
(`testing/pe_mesh.py`, at 0.05 yr) runs in this process.

Each of the JAX package's sharding tests (``tests/test_parallel.py``:54,
:69, :75, :91, :107, :114) has its counterpart here at that test's
tolerance: the walker-sharded tiny log L against the unsharded batch at
``rtol=1e-12``, the placements, the mean from per-rank partial sums at
1e-12, the frequency-sharded waveform bit for bit, the walker-sharded
stretch step at 1e-12. Across the packages, on the same inputs: the
walker-sharded log L against the JAX ``_ll`` on its 8-device mesh at
relative 1e-9 with equal knot counts, and the sharded stretch step on the
draws JAX's sharded step takes from its key (rebuilt from its
``jax.random.split`` sequence) against that step at 1e-12.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from emri_frequencydomainwaveforms_tpu.inference.moves.stretch import StretchMove as JStretch
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table as j_table
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    fd_waveform_core as j_core,
    waveform_prologue as j_prologue,
)
from emri_frequencydomainwaveforms_tpu.parallel.mesh import walker_mesh as j_walker_mesh
from emri_frequencydomainwaveforms_tpu_torch import graft_entry
from emri_frequencydomainwaveforms_tpu_torch.inference.moves.stretch import StretchMove
from emri_frequencydomainwaveforms_tpu_torch.parallel import mesh as t_mesh
from emri_frequencydomainwaveforms_tpu_torch.testing import batch_dependence, mesh_cases, pe_mesh

RANKS = 4
P0S = np.linspace(9.8, 10.2, 16)
BETAS = np.array([1.0, 0.5])
F_NP = mesh_cases.F0 + mesh_cases.DF * np.arange(mesh_cases.NF)


def _jax_stretch_draws(key, ntemps, nh, a=2.0):
    """The draws JAX's StretchMove.propose takes from ``key``, per half."""
    out = []
    for _ in range(2):
        key, k_z, k_c, k_u = jax.random.split(key, 4)
        z = ((a - 1.0) * jax.random.uniform(k_z, (ntemps, nh)) + 1.0) ** 2 / a
        partner = jax.random.randint(k_c, (ntemps, nh), 0, nh)
        u = jax.random.uniform(k_u, (ntemps, nh))
        out.append(tuple(torch.from_numpy(np.array(v)) for v in (z, partner, u)))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the ranks run one intra-op thread each; this process's own tiny-model
    # evaluations and the dry run's replay do too, so that a loaded host
    # (the suite's other workers) does not stall them in thread barriers
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def step_inputs():
    # tests/test_parallel.py::test_stretch_step_walker_sharded's ensemble
    coords = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 3)))
    return coords, _jax_stretch_draws(jax.random.PRNGKey(7), 2, 8)


@pytest.fixture(scope="module")
def pe_spec():
    return pe_mesh.pe_problem(batch_dependence.CPU_ARGS, 8.5, "cpu")


@pytest.fixture(scope="module")
def ranks(step_inputs):
    coords, draws = step_inputs
    return t_mesh.run_ranks(mesh_cases.reference_cases, RANKS, (P0S, coords, BETAS, draws),
                            backend="gloo")


def _jax_ll(p0):
    table = j_table(4, l_max=mesh_cases.L_MAX)
    pro = j_prologue(1e6, 10.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0, t_years=0.005, table=table,
                     k_max=8, eps=1e-2, max_steps=64)
    out = j_core(pro, table, jnp.asarray(F_NP), channels=True,
                 uniform=(float(F_NP[0]), float(F_NP[1] - F_NP[0])))
    return -0.5 * sum(jnp.sum(o * o) for o in out) * 1e34, pro.n_live


class TestWalkerSharding:
    def test_sharded_likelihood_matches_unsharded(self, ranks):
        assert ranks["world"] == RANKS
        expect, knots = mesh_cases.log_like(torch.as_tensor(P0S))
        np.testing.assert_allclose(ranks["ll"].numpy(), expect.numpy(), rtol=1e-12)
        np.testing.assert_array_equal(ranks["n_live"].numpy(), knots.numpy())

    def test_sharded_likelihood_matches_jax_mesh(self, ranks):
        mesh = j_walker_mesh(8)
        sharded_in = jax.device_put(jnp.asarray(P0S), NamedSharding(mesh, P("walkers")))
        ll_j, knots_j = jax.jit(jax.vmap(_jax_ll),
                                out_shardings=NamedSharding(mesh, P("walkers")))(sharded_in)
        np.testing.assert_allclose(ranks["ll"].numpy(), np.asarray(ll_j), rtol=1e-9, atol=0)
        np.testing.assert_array_equal(ranks["n_live"].numpy(), np.asarray(knots_j))

    def test_shard_walkers_helper(self, ranks):
        # (16, 6) split over 4 ranks: 4 rows each, the leading axis sharded
        assert ranks["shard_local_shape"] == (16 // RANKS, 6)
        assert ranks["shard_placements"] == [("Shard", 0)]

    def test_walker_psum_reduction(self, ranks):
        expect, _ = mesh_cases.log_like(torch.as_tensor(P0S))
        np.testing.assert_allclose(float(ranks["mean"]), float(torch.mean(expect)), rtol=1e-12)


class TestFrequencySharding:
    def test_frequency_sharded_generation(self, ranks):
        # bins are independent given the spline data: every rank's own bin
        # range, gathered, equals the whole-grid call to the bit
        whole, _ = mesh_cases.generate(torch.tensor([10.0], dtype=torch.float64))
        assert ranks["frequency_placements"] == [("Shard", 1)]
        assert ranks["frequency_local_shape"] == (4, mesh_cases.NF // RANKS)
        np.testing.assert_array_equal(ranks["gen_sharded"].numpy(), ranks["gen_whole"].numpy())
        np.testing.assert_array_equal(ranks["gen_whole"].numpy(),
                                      torch.stack(whole)[:, 0].numpy())

    def test_replicated_helper(self, ranks):
        assert ranks["replicated_all"]
        np.testing.assert_array_equal(ranks["replicated_local"].numpy(), np.arange(8.0))

    def test_pe_likelihood_by_frequency_shards(self, pe_spec):
        # the PE template on each of two run-aligned bin ranges equals the
        # whole grid's bins to the bit, and log L from the shards' partial
        # sums added in order equals the one sum over all bins to 1e-12 (the
        # sharded evaluation as `[mesh]` runs it on the card, one process)
        like, last = pe_mesh.pe_likelihood(pe_spec, "cpu")
        x = torch.as_tensor(pe_spec["x"][:4])
        ll = like(x)
        whole = last["template"]
        assert float(ll.abs().min()) > 0 and float(whole.abs().max()) > 0
        nf = len(pe_spec["f"])
        bounds = t_mesh.frequency_bounds(nf, 1, 2)
        parts = []
        for lo, hi in bounds:
            parts.append(like.residual_power(x, bins=(lo, hi)))
            np.testing.assert_array_equal(last["template"].numpy(), whole[..., lo:hi].numpy())
        np.testing.assert_allclose((-2.0 * t_mesh.ordered_sum(torch.stack(parts, -1))).numpy(),
                                   ll.numpy(), rtol=1e-12, atol=0)


class TestShardedSamplerStep:
    def test_stretch_step_walker_sharded(self, ranks, step_inputs):
        coords, draws = step_inputs
        c = torch.as_tensor(coords)
        ll0 = mesh_cases.gaussian_ll(c)
        exp = StretchMove().step(c, ll0, torch.zeros_like(ll0), torch.as_tensor(BETAS), draws,
                                 lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype),
                                 mesh_cases.gaussian_ll)
        np.testing.assert_allclose(ranks["step_coords"].numpy(), exp[0].numpy(), rtol=1e-12)
        np.testing.assert_allclose(ranks["step_ll"].numpy(), exp[1].numpy(), rtol=1e-12)

    def test_stretch_step_matches_jax_sharded_step(self, ranks, step_inputs):
        coords, _ = step_inputs
        mesh = j_walker_mesh(8)

        def logl(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        def logp(x):
            return jnp.zeros(x.shape[:-1])

        def step(c):
            out = JStretch().propose(jax.random.PRNGKey(7), c, logl(c), logp(c),
                                     jnp.asarray(BETAS), logp, logl)
            return out[0], out[1], out[3]

        csh = NamedSharding(mesh, P(None, "walkers", None))
        c_j, ll_j, acc_j = jax.jit(step)(jax.device_put(jnp.asarray(coords), csh))
        np.testing.assert_allclose(ranks["step_coords"].numpy(), np.asarray(c_j), rtol=1e-12)
        np.testing.assert_allclose(ranks["step_ll"].numpy(), np.asarray(ll_j), rtol=1e-12)
        np.testing.assert_array_equal(ranks["step_accepted"].numpy(), np.asarray(acc_j))


def test_dryrun_multichip_cpu():
    out = graft_entry.dryrun_multichip(RANKS, device="cpu")
    assert out["step_coords"].shape == (2, 4 * RANKS, 6)
    assert out["mesh"] == (RANKS // 2, 2)
    assert torch.equal(out["chain_accepted"], out["replay_accepted"])
    assert out["exact"]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.walker_mesh()
    with pytest.raises(ValueError, match="backend"):
        t_mesh.run_ranks(print, 2, backend="mpi")


def test_shard_and_frequency_bounds():
    # torch.chunk's split, trailing shards ragged or empty
    assert t_mesh.shard_bounds(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert t_mesh.shard_bounds(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    # frequency shards cut on run boundaries; 15,780 bins of 64-bin runs
    bounds = t_mesh.frequency_bounds(15_780, 64, 2)
    assert bounds == [(0, 7_936), (7_936, 15_780)]
    assert all(lo % 64 == 0 for lo, _ in bounds)
    assert t_mesh.frequency_bounds(15_780, 1, 2) == [(0, 7_890), (7_890, 15_780)]


def test_ordered_sum_adds_in_index_order():
    parts = torch.tensor([[1e16, 1.0, -1e16, 1.0]], dtype=torch.float64)
    # ((1e16 + 1) - 1e16) + 1 = 1 in float64; another order gives 2 or 0
    assert float(t_mesh.ordered_sum(parts)[0]) == 1.0
