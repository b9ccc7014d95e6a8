"""Trajectory, amplitudes, mode selection, FD and TD summation, the batched
waveform module and the waveform facades."""
