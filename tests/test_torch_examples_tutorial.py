"""The port's FD-waveform tutorial on the CPU, against the JAX package.

``examples/torch_fd_waveforms_tutorial.py`` runs sections 1-3 through its
``main(["--device", "cpu", "--T", "0.05", "--sections", "1-3"])`` at the
reference tutorial's CI-quick size (0.05 yr, dt = 10 s; the production
physics). Its returned checks (FD against the DFT of TD unwindowed, the
inverse FFT of the two-sided FD spectrum against TD, and the Hann-windowed
adapters) are held to the same quantities computed through the JAX
package's facades and ``utils.fdutils`` at the same arguments, to 1e-3
relative (the two packages' spectra agree to ~1e-5). The reference
tutorial itself takes over 3 minutes on an 8-core CPU, most of it
compiling each facade configuration, so section 2's single-mode share is
held to the tutorial's own claim instead: the (2,2,0) share of the h+
power in (0, 1). Sections 4-5 are in
``tests/test_torch_examples_tutorial_scaling.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_examples import load_example

T_QUICK = 0.05


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mismatch(a, b):
    """The tutorial's unweighted mismatch (its `_mismatch`)."""
    num = np.abs(np.vdot(a, b))
    den = np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real) + 1e-300
    return float(1.0 - num / den)


def test_tutorial_matches_the_reference(capsys):
    checks = load_example("torch_fd_waveforms_tutorial").main(
        ["--device", "cpu", "--T", str(T_QUICK), "--sections", "1-3"])
    out = capsys.readouterr().out
    for section in ("[1]", "[2]", "[3]"):
        assert section in out
    assert "[4]" not in out and "[5]" not in out
    assert set(checks) == {"mm_unwindowed", "frac_220", "overlap", "mm_windowed"}
    assert all(np.isfinite(v) for v in checks.values())
    assert 0.0 < checks["frac_220"] < 1.0

    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        FastSchwarzschildEccentricFlux,
        default_frequencies,
    )
    from emri_frequencydomainwaveforms_tpu.utils.fdutils import (
        get_fd_windowed,
        get_fft_td_windowed,
    )
    from emri_frequencydomainwaveforms_tpu.utils.windows import hann

    M, mu, p0, e0 = 1e6, 50.0, 12.0, 0.4
    theta, phi = np.pi / 3, np.pi / 4
    kw = dict(T=T_QUICK, dt=10.0, eps=1e-2, return_channels=True)
    h_td = FastSchwarzschildEccentricFlux(sum_kwargs={"output_type": "td"})(
        M, mu, p0, e0, theta, phi, **kw)
    full = FastSchwarzschildEccentricFlux(sum_kwargs={"output_type": "fd"})(
        M, mu, p0, e0, theta, phi, **kw)
    freq = default_frequencies(T_QUICK, 10.0)
    pos = freq >= 0
    mm = _mismatch(full[0][pos], (np.fft.fftshift(np.fft.fft(h_td[0])) * 10.0)[pos])
    n = len(h_td[0])
    mid = slice(n // 4, 3 * n // 4)
    a = (np.fft.ifft(np.fft.ifftshift(full[0])) / 10.0).real[mid]
    b = np.asarray(h_td[0])[mid]
    ov = np.dot(a, b) / np.sqrt(np.dot(a, a) * np.dot(b, b) + 1e-300)
    w = np.asarray(hann(n))
    td_w = get_fft_td_windowed(h_td, w, 10.0)[0][pos]
    fd_w = get_fd_windowed(full, w)[0][pos]
    mm_w = _mismatch(fd_w, td_w)
    for name, ref in (("mm_unwindowed", mm), ("overlap", ov), ("mm_windowed", mm_w)):
        assert abs(checks[name] - ref) <= 1e-3 * abs(ref), (name, checks[name], ref)
