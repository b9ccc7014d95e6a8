"""`tools/torch_convergence_l56.py::fd_mismatch_lpair` against
`tools/convergence_l56.py::fd_mismatch_lpair` on the CPU, at a cut size.

The first of the study's fixed cases (M 1e6, mu 10, e0 0.35, its viewing
angles) at a given p0, over 0.02 yr with harmonics |n| <= 4: the FD
waveforms of the l <= 4 and l <= 6 inventories through each package's
general kernel on the study's 60000-bin grid, and their unwindowed
mismatch. Amplitudes are float32 projections in both packages, so the
mismatch agrees to 1e-5 relative.
"""

from tools import convergence_l56 as j_l56
from tools import torch_convergence_l56 as t_l56


def test_fd_mismatch_lpair_matches_the_original():
    m_mass, mu, e0, th, ph = t_l56.CASES[0]
    kw = dict(t_years=0.02, n_max=4, l_pair=(4, 6))
    ref = j_l56.fd_mismatch_lpair(m_mass, mu, 9.5, e0, th, ph, **kw)
    got = t_l56.fd_mismatch_lpair(m_mass, mu, 9.5, e0, th, ph, device="cpu", **kw)
    assert 1e-6 < ref < 1e-2
    assert abs(got / ref - 1.0) < 1e-5
