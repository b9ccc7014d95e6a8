"""`tools/torch_xcheck_diag.py` against `tools/xcheck_diag.py`'s computation
in the JAX package, on the CPU.

The original's steps live inside its ``main``; this test runs them on the
JAX package as written there (gate 1's source and configuration, the
eps-selected 16 slots, the banded uniform-grid path over the whole grid at
runs of 64 and 16 bins, the general kernel at 32 nodes per segment on every
``stride``-th bin) at a cut grid, the first ``NF`` positive bins of the
1-yr grid, and holds the twin's functions to them:

* the selection and the prologue (both packages interpolate the reference's
  rwz flux grid, carried across): the same 16 modes, the same knot count,
  knots within 1e-10 relative;
* on the reference's prologue carried into the port, each kernel's four
  outputs within 1e-5 of the reference output's RMS (float32 dense pass,
  the same tolerance as `tests/test_torch_general.py`), and the twin's
  ablation numbers within 1e-5 absolute of the reference's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models import amplitude as j_amp
from emri_frequencydomainwaveforms_tpu.models import flux as j_flux
from emri_frequencydomainwaveforms_tpu.models import waveform as j_wf
from emri_frequencydomainwaveforms_tpu_torch import convert
from tools import torch_xcheck_diag as twin

NF, STRIDE = 60000, 61


@pytest.fixture(scope="module")
def reference():
    grid = j_flux.default_flux_grid(True, True, True)
    table = j_amp.default_mode_table(30)
    kw = dict(t_years=twin.T_YEARS, k_max=twin.K_MAX, eps=twin.EPS,
              max_steps=twin.MAX_STEPS, **twin.PHYS_KW)
    sel = np.asarray(jax.jit(lambda: j_wf.waveform_prologue(
        *twin.SOURCE, table=table, **kw).sel.idx)())
    table_k = table.take(sel)
    pro = jax.jit(lambda: j_wf.waveform_prologue(
        *twin.SOURCE, table=table_k, forced_idx=np.arange(len(sel)), **kw))()
    f_np = twin.positive_grid(NF)
    sub = np.arange(0, NF, STRIDE)
    uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))

    def banded(r):
        out = jax.jit(lambda p: j_wf.fd_waveform_core(
            p, table_k, jnp.asarray(f_np), channels=True, uniform=uniform, bins_per_run=r,
            turnover_slots=2))(pro)
        return [np.asarray(o, np.float64)[sub] for o in out]

    g32 = [np.asarray(o, np.float64) for o in jax.jit(lambda p: j_wf.fd_waveform_core(
        p, table_k, jnp.asarray(f_np[sub]), channels=True, turnover_slots=2,
        nodes_per_segment=32))(pro)]
    return dict(grid=grid, sel=sel, pro=jax.tree_util.tree_map(np.asarray, pro),
                table_k=table_k, f_np=f_np, sub=sub, b64=banded(64), b16=banded(16), g32=g32)


def test_positive_grid_is_the_reference():
    freq = j_wf.default_frequencies(1.0, 10.0)
    assert np.array_equal(twin.positive_grid(), freq[freq > 0])
    assert np.array_equal(twin.positive_grid(NF), freq[freq > 0][:NF])


def test_gate1_prologue_matches_the_reference(reference):
    grid = convert.flux_grid_from_numpy(*reference["grid"], device="cpu")
    pro, table_k = twin.gate1_prologue("cpu", flux_grid=grid)
    ref = reference["pro"]
    assert np.array_equal(pro.sel.idx[0].numpy(), np.arange(len(reference["sel"])))
    for a, b in ((table_k.ls, reference["table_k"].ls), (table_k.ms, reference["table_k"].ms),
                 (table_k.ns, reference["table_k"].ns)):
        assert np.array_equal(a, b)
    n = int(pro.n_live[0])
    assert n == int(ref.n_live)
    for name in ("t_knots", "phi_phi", "phi_r"):
        a, b = getattr(ref, name)[:n], getattr(pro, name)[0, :n].numpy()
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(a)), name


def test_kernels_and_ablation_match_the_reference(reference):
    pro = convert.prologue_from_numpy(reference["pro"], device="cpu")
    table_k, f_np, sub = reference["table_k"], reference["f_np"], reference["sub"]
    got = dict(b64=twin.banded(pro, table_k, f_np, sub, 64),
               b16=twin.banded(pro, table_k, f_np, sub, 16),
               g32=twin.general(pro, table_k, f_np[sub], 32))
    for key, outs in got.items():
        for a, b in zip(reference[key], outs):
            scale = np.sqrt(np.mean(a**2))
            assert scale > 0 and np.isfinite(b).all()
            assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(a)), key
            assert np.sqrt(np.mean((a - b) ** 2)) <= 1e-5 * scale, key
    ref_rel = twin.rel(reference["b64"], reference["g32"])
    assert abs(twin.rel(got["b64"], got["g32"]) - ref_rel) <= 1e-5
    assert abs(twin.rel(got["b16"], got["g32"]) - twin.rel(reference["b16"], reference["g32"])) \
        <= 1e-5
    order, errs = twin.worst_bins(got["b64"], got["g32"], count=3)
    assert len(order) == 3 and errs[0] >= errs[1] >= errs[2] >= 0.0


def test_twin_main_quick_on_the_cpu(reference, capsys, monkeypatch):
    """``main`` end to end at the cut grid (``--quick``; the rwz flux grid
    is the reference's, carried across): prints the original's baseline
    line, and its baseline is the reference's within 1e-5."""
    from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp

    grid = convert.flux_grid_from_numpy(*reference["grid"], device="cpu")
    monkeypatch.setattr(t_insp, "default_flux_grid", lambda *a, **k: grid)
    out = twin.main(["--nf", str(NF), "--stride", str(STRIDE), "--quick", "--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("baseline  banded(r=64) vs general(s=32): ")
    ref_rel = twin.rel(reference["b64"], reference["g32"])
    assert abs(out["baseline"] - ref_rel) <= 1e-5
