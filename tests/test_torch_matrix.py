"""The run matrix's torch twin (`tools/torch_test_matrix.py`) against its
original (`tools/test_matrix.sh`), and its paper-source rows against the
JAX CLI on the CPU.

The twin's six rows are the shell script's, flag for flag, at both sizes,
and each parses to the same namespace in the port's parser as in the JAX
CLI's. The five PE rows (on the paper source: TD template with the
windowed TD injection, TD template injected by itself, FD template with
the windowed TD injection, FD template injected by itself; then the
tutorial source's FD template) run at a tiny size through both packages'
`run_emri_pe` (`tests/helpers_matrix.py`: the sizes, the shared p0 and
the tolerances), once per row for the module and all in this one
process, in the order that lets the JAX runs reuse each other's compiled
programs (most of a JAX run here is its ~300 compilations; a row alone in
a process of its own under the whole suite's load took 638 s). Last, the
FD template with its level-1 node tables evaluated in walker chunks
(`summation_fd._level1_walker_chunks`, which keeps the 4-yr grid's
16-walker batch within the card beside other work) against one pass.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from emri_frequencydomainwaveforms_tpu.cli import check_mode_by_mode as j_scan
from emri_frequencydomainwaveforms_tpu.cli import emri_pe as j_cli
from emri_frequencydomainwaveforms_tpu_torch.cli import check_mode_by_mode as t_scan
from emri_frequencydomainwaveforms_tpu_torch.cli import emri_pe as t_cli
from emri_frequencydomainwaveforms_tpu_torch.models import summation_fd
from emri_frequencydomainwaveforms_tpu_torch.models import waveform as t_wf
from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import default_mode_table
from tests.helpers_matrix import SNR_TOL, assert_log_like_close, run_both, tiny_argv
from tools import torch_test_matrix as tm

SCRIPT = Path(__file__).resolve().parents[1] / "tools" / "test_matrix.sh"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the port's side here is small tensors; under the whole suite's load
    # eight intra-op threads only contend (the chunk test: 1.5 s alone,
    # 97-151 s a case beside the other workers)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shell_rows(quick: bool) -> list[tuple[str, list[str]]]:
    """The runs of tools/test_matrix.sh as (cli, argv), its shell variables
    expanded for QUICK=1 or the full size."""
    text = SCRIPT.read_text().replace("\\\n", " ")
    lines = [line.strip() for line in text.splitlines()]
    clis = {"PY": "emri_frequencydomainwaveforms_tpu.cli.emri_pe",
            "SCAN": "emri_frequencydomainwaveforms_tpu.cli.check_mode_by_mode"}
    for var, module in clis.items():
        assert f'{var}="python -m {module}"' in lines
    branch = lines.index("else") + 1 if not quick else next(
        i for i, line in enumerate(lines) if line.startswith('if [ "${QUICK:-0}" = "1" ]')) + 1
    env = dict(kv.split("=") for kv in lines[branch].split("; "))
    env["PAPER"] = re.search(r'^PAPER="([^"]*)"$', text, re.M).group(1)
    rows = []
    for line in lines:
        words = line.split()
        if words and words[0] in ("$PY", "$SCAN"):
            argv = []
            for word in words[1:]:
                argv += env[word[1:]].split() if word.startswith("$") else [word]
            rows.append(("pe" if words[0] == "$PY" else "scan", argv))
    return rows


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_twin_rows_are_the_shell_scripts(quick):
    rows = shell_rows(quick)
    assert len(rows) == 6 and [cli for cli, _ in rows] == ["pe"] * 5 + ["scan"]
    assert tm.row_flags(quick) == rows
    for cli, argv in rows:
        # the port's parsers read each row as the JAX CLIs do
        t, j = (t_cli, j_cli) if cli == "pe" else (t_scan, j_scan)
        assert vars(t.build_parser().parse_args(argv)) == vars(j.build_parser().parse_args(argv))


def test_parse_rows():
    assert tm.parse_rows("all") == [1, 2, 3, 4, 5, 6]
    assert tm.parse_rows("1,3") == [1, 3] and tm.parse_rows("2-4,6") == [2, 3, 4, 6]
    with pytest.raises(ValueError):
        tm.parse_rows("0-2")


@pytest.fixture(scope="module", params=[1, 3, 4, 2, 5], ids=lambda r: f"row{r}")
def row(request, tmp_path_factory):
    return request.param, run_both(request.param, tmp_path_factory.mktemp(f"row{request.param}"))


def test_injection_snr_matches_the_jax_cli(row):
    _, run = row
    want, got = run["snr"]
    assert abs(got / want - 1.0) < SNR_TOL, (got, want)


def test_log_like_at_the_truth_matches_the_jax_cli(row):
    i, run = row
    want, got = run["ll"]["truth"]
    assert_log_like_close(want, got)
    assert run["out"]["ll_truth"] == got[0]  # the same walker alone and in a batch of 4
    if tm.pe_args(run["argv"]).injectFD:
        assert abs(got[0]) < 1e-3  # the template is its own injection
    else:
        # the windowed TD injection (its own eps selection) is not the template
        assert got[0] < -1.0


def test_log_like_at_the_start_walkers_matches_the_jax_cli(row):
    _, run = row
    want, got = run["ll"]["start"]
    assert_log_like_close(want, got)
    out = run["out"]
    assert out["backend"].iteration == 1 and np.isfinite(out["chain"]).all()
    assert 0 < out["n_knots"] <= tm.pe_args(run["argv"]).max_steps
    assert np.isfinite(np.asarray(run["ref"]["chain"])).all()
    np.testing.assert_array_equal(out["truth"], run["ref"]["truth"])


@pytest.mark.parametrize("turnover_slots", [0, 2])
def test_walker_chunked_level1_tables_are_one_pass(monkeypatch, turnover_slots):
    # the PE template's FD core on 5 walkers near row 3's tiny-size truth:
    # one walker at a time (a budget of 1 node) and two walkers of main slots
    # a chunk give the one-pass spectra to the bit
    args = t_cli.build_parser().parse_args(tiny_argv(3))
    table = default_mode_table(8, l_max=3)
    rng = np.random.default_rng(5)
    p0 = torch.tensor(7.6 + 0.05 * rng.random(5), dtype=torch.float64)
    e0 = torch.tensor(args.e0 + 0.01 * rng.random(5), dtype=torch.float64)
    pro = t_wf.waveform_prologue(args.M, args.mu, p0, e0, 0.7, 0.5, 1.0, 1.0, 2.0,
                                 t_years=args.Tobs, table=table, k_max=args.kmax, eps=args.eps,
                                 max_steps=args.max_steps, device="cpu")
    freq = t_wf.default_frequencies(args.Tobs, args.dt)
    f_np = freq[freq > 0][::args.downsample]
    kw = dict(channels=True, uniform=(float(f_np[0]), float(f_np[1] - f_np[0])),
              turnover_slots=turnover_slots, out_f32=True)
    one_pass = t_wf.fd_waveform_core(pro, table, len(f_np), **kw)
    nodes = pro.sel.idx.shape[1] * (len(f_np) + 1)  # one walker's main-slot nodes (r = 1)
    for budget in (1, 2 * nodes):
        monkeypatch.setattr(summation_fd, "_LEVEL1_NODES", budget)
        chunked = t_wf.fd_waveform_core(pro, table, len(f_np), **kw)
        assert all(torch.equal(a, b) for a, b in zip(one_pass, chunked))
    assert float(one_pass[0].abs().max()) > 0.0
