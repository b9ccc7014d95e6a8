"""The inspiral, integrated by SciPy: p, e and the two orbital phases from
the flux balance dE/dt, dL/dt = the flux table, through the exact Jacobian
d(E, L)/d(p, e), until the observation time or p = 6 + 2e + 0.12."""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp
from scipy.interpolate import CubicSpline

from . import physics as ph


class Inspiral:
    """One source's trajectory: its dense solution and, on a fine table of
    times (``sub`` points inside every step of the integrator), the state,
    the two frequencies and their time derivatives.

    Times ``t`` are seconds; ``scale`` is the central mass in seconds.
    """

    def __init__(self, flux: ph.FluxTable, mass_1, mass_2, p0, e0, t_years, phi_phi0=0.0,
                 phi_r0=0.0, sub=8, phase_dtype=np.float64):
        self.flux, self.nu, self.scale = flux, mass_2 / mass_1, mass_1 * ph.MTSUN_SI
        tau_max = t_years * ph.YRSID_SI / self.scale

        def plunge(_, y):
            return y[0] - (6.0 + 2.0 * y[1] + ph.DELTA_P_STOP)

        plunge.terminal = True
        sol = solve_ivp(self._rate, (0.0, tau_max), [p0, e0, phi_phi0, phi_r0], method="DOP853",
                        rtol=1e-12, atol=[1e-12, 1e-12, 1e-9, 1e-9], dense_output=True,
                        events=plunge)
        if sol.status < 0:
            raise RuntimeError(f"the reference trajectory failed: {sol.message}")
        self.sol, self.tau_end = sol.sol, float(sol.t[-1])
        self.phase_dtype = phase_dtype
        steps = sol.t
        frac = np.arange(sub) / sub
        tau = np.concatenate([(steps[:-1, None] + frac * np.diff(steps)[:, None]).ravel(),
                              steps[-1:]])
        self.tau = tau
        self.t = tau * self.scale
        y = sol.sol(tau)
        self.p, self.e = y[0], y[1]
        rates = np.array([self._rate(0.0, y[:, i]) for i in range(len(tau))]).T
        self.pdot, self.edot = rates[0], rates[1]
        self.om_phi, self.om_r = rates[2], rates[3]
        # dOmega/dtau by complex steps in p and e along (pdot, edot)
        h = 1e-30
        op_p, or_p = ph.frequencies(self.p + 1j * h, self.e + 0j)
        op_e, or_e = ph.frequencies(self.p + 0j, self.e + 1j * h)
        self.dom_phi = (op_p.imag * self.pdot + op_e.imag * self.edot) / h
        self.dom_r = (or_p.imag * self.pdot + or_e.imag * self.edot) / h

    def _rate(self, _, y):
        p, e = y[0], max(y[1], 1e-9)
        e_dot, l_dot = self.flux(p, e)
        jpp, jpe, jlp, jle = ph.el_jacobian(p, e)
        det = jpp * jle - jpe * jlp
        om_phi, om_r = ph.frequencies(p, e)
        return [self.nu * (jle * e_dot - jpe * l_dot) / det,
                self.nu * (-jlp * e_dot + jpp * l_dot) / det, float(om_phi), float(om_r)]

    def phases(self, t):
        """(Phi_phi, Phi_r) at times ``t`` (s), in ``phase_dtype`` (the
        control rounds them to float32 where they are produced)."""
        y = self.sol(np.asarray(t) / self.scale)
        return (y[2].astype(self.phase_dtype).astype(np.float64),
                y[3].astype(self.phase_dtype).astype(np.float64))

    def mode(self, m, n):
        """f (Hz) and fdot (Hz/s) of harmonic (m, n) on the table, and the
        spline of fdot (its derivative is fddot)."""
        two_pi = 2.0 * np.pi
        f = (m * self.om_phi + n * self.om_r) / (two_pi * self.scale)
        fdot = (m * self.dom_phi + n * self.dom_r) / (two_pi * self.scale ** 2)
        return f, fdot, CubicSpline(self.t, fdot)
