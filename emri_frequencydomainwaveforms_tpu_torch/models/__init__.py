"""Trajectory, amplitudes, mode selection, FD summation and the batched
waveform module."""
