"""Shared utilities: constants, spin-weighted harmonics and the choice of device."""
