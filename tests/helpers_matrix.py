"""One PE row of the run matrix (`tools/test_matrix.sh`, its twin
`tools/torch_test_matrix.py`) at a tiny size through both packages' CLIs.

The row keeps its own ``-template`` / ``-injectFD`` / ``-window_flag`` and
source; the size is cut to Tobs 0.02 yr, 4 walkers x 1 temperature x 1
step, downsample 8 (3945 positive bins), 16 mode slots, and the physics to
the Peters-Mathews flux with flat amplitudes. Both packages' duration
solves are replaced by the one p0 of the JAX solve for that source
(`emri_frequencydomainwaveforms_tpu.models.inspiral.get_p_at_t(M, mu, e0,
0.99 * 0.02, flux="pm")`, constants below), so both start from the same
truth and the same walker ball. The JAX CLI writes its HDF chain file, the
port its own (h5py is installed here), both under ``tmp_path``.

Held against the JAX CLI (`run_both` runs both, the tests assert):
- the injection SNR, relative 5e-5: both spectra are float32, and the
  JAX TD template takes its DFT in float32 matmuls (~1e-7 rad; 5.0e-06
  measured on row 2), where the port's is a float64 rfft;
- log L at the truth and at the 4 start walkers (``sampler.log_like_fn``
  against ``out["likelihood"]``), |dlogL| <= 1e-3 max(1, |logL|), the
  tolerance of `tests/test_torch_pe.py` for float32 spectra (measured:
  2.5e-06 relative at log L ~ -374 on rows 1 and 3, 2e-05 absolute near
  log L = 0).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.cli import emri_pe as j_cli
from emri_frequencydomainwaveforms_tpu.models import inspiral as j_insp
from emri_frequencydomainwaveforms_tpu_torch.models import inspiral as t_insp
from tools import torch_test_matrix as tm

# the JAX duration solve at Tobs 0.02 (pm flux) of the matrix's two sources
P0_PAPER = 7.511856496321689  # M 3670041.7362535275, mu 292.0583167470244, e0 0.5794130830706371
P0_TUTORIAL = 7.047850300564866  # M 1e6, mu 10, e0 0.35
TINY = {"-Tobs": "0.02", "-nwalkers": "4", "-downsample": "8"}
PHYSICS = ["-flux", "pm", "-amp", "flat", "-kmax", "16"]
SNR_TOL = 5e-5
LL_TOL = 1e-3


def tiny_argv(row: int) -> list[str]:
    """Row ``row`` (1-5) of the full-size matrix at the tiny size."""
    cli, argv = tm.row_flags(False)[row - 1]
    assert cli == "pe"
    argv = list(argv)
    for flag, value in TINY.items():
        argv[argv.index(flag) + 1] = value
    return argv + PHYSICS


def run_both(row: int, tmp_path) -> dict:
    """Run row ``row`` through both CLIs from the JAX solve's p0. Returns
    the port's run (``out``) and both packages' SNR and log L at the 4
    start walkers and at the truth (as a batch of 4 copies: the JAX
    likelihood compiled at that batch for the start)."""
    argv = tiny_argv(row)
    p0 = P0_TUTORIAL if row == 5 else P0_PAPER
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_insp, "get_p_at_t", lambda *a, **k: jnp.asarray(p0))
        mp.setattr(t_insp, "get_p_at_t", lambda *a, **k: torch.tensor([p0], dtype=torch.float64))
        jargs = j_cli.build_parser().parse_args(argv)
        jargs.outname = str(tmp_path / "jax.h5")
        ref = j_cli.run_emri_pe(jargs)
        (tmp_path / "port").mkdir()
        out = tm.run_pe(argv, "cpu", outdir=str(tmp_path / "port"))
    start = out["start"].reshape(-1, 6)
    truth4 = np.repeat(out["truth"][None], len(start), axis=0)
    ll = {name: (np.asarray(ref["sampler"].log_like_fn(jnp.asarray(x))),
                 out["likelihood"](x).numpy())
          for name, x in (("start", start), ("truth", truth4))}
    return dict(out=out, ref=ref, argv=argv, snr=(ref["snr"], out["snr"]), ll=ll)


def assert_log_like_close(want, got):
    """|dlogL| <= LL_TOL max(1, |logL|), elementwise."""
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), LL_TOL * np.maximum(1.0, np.abs(want)))
