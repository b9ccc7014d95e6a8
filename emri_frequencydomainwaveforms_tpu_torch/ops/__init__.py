"""Numerics substrate: splines, tridiagonal solves, special functions, 2-D
interpolation and the hand-written CUDA dense-pass kernel."""

from .bessel import bessel_jn, kve_one_third, kve_one_third_imag
from .cubic_spline import (
    CubicSplineCoeffs,
    CubicSplineInterpolant,
    fit_cubic_spline,
    spline_eval,
    spline_eval_at_segments,
)
from .interp2d import interp2d_bicubic
from .tridiag import thomas_solve

__all__ = [
    "thomas_solve",
    "CubicSplineCoeffs",
    "CubicSplineInterpolant",
    "fit_cubic_spline",
    "spline_eval",
    "spline_eval_at_segments",
    "kve_one_third",
    "kve_one_third_imag",
    "bessel_jn",
    "interp2d_bicubic",
]
