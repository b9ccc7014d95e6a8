"""Shared utilities: constants and spin-weighted harmonics."""
