"""Numerics substrate: splines, tridiagonal solves, special functions and the
hand-written CUDA dense-pass kernel."""
