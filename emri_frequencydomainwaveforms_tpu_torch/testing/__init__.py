"""Fixtures shared by the CPU tests and ``chip_smoke.py``; no entry point
of the port uses them."""
