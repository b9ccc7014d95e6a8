"""Physical constants (SI + geometric-unit conversion factors).

Mirrors the constant set the reference pipeline relies on
(``few.utils.constants`` usage at reference ``emri_pe.py:63`` and
``LISAanalysistools/lisatools/utils/constants.py``), recomputed from CODATA /
IAU nominal values rather than copied.
"""

from __future__ import annotations

import math

# --- fundamental (SI) ---
C_SI = 299_792_458.0  # speed of light [m/s]
G_SI = 6.674e-11  # Newton's constant [m^3 kg^-1 s^-2]

# --- solar / astronomical ---
MSUN_SI = 1.98848e30  # solar mass [kg]
GMSUN = 1.32712440041279419e20  # nominal solar mass parameter GM_sun [m^3/s^2]

# geometric-unit solar mass in seconds / meters
MTSUN_SI = GMSUN / C_SI**3  # ~4.925490947641267e-06 s
MRSUN_SI = GMSUN / C_SI**2  # ~1476.6250385063147 m

PC_SI = 3.0856775814913674e16  # parsec [m]
Gpc = 1.0e9 * PC_SI  # gigaparsec [m]

AU_SI = 1.495978707e11  # astronomical unit [m]

# sidereal year in seconds (used by few for T in years -> seconds)
YRSID_SI = 31_558_149.763545603  # 365.256363004 d * 86400 s/d

PI = math.pi

# --- derived, frequently used ---
TWOPI = 2.0 * math.pi

__all__ = [
    "C_SI",
    "G_SI",
    "MSUN_SI",
    "GMSUN",
    "MTSUN_SI",
    "MRSUN_SI",
    "PC_SI",
    "Gpc",
    "AU_SI",
    "YRSID_SI",
    "PI",
    "TWOPI",
]
