"""emri_frequencydomainwaveforms_tpu_torch: the PyTorch + CUDA port.

A second implementation of ``emri_frequencydomainwaveforms_tpu`` for NVIDIA
Hopper GPUs. It mirrors the JAX package's module layout and function names
(``models/waveform.py`` here is the counterpart of ``models/waveform.py``
there) and is held against it by the ``tests/test_torch_*.py`` parity tests.

This package imports ``torch``, ``numpy`` and ``ctypes`` only; it never
imports ``jax`` or the JAX package, so it runs on a machine without JAX.

Conventions:

* the walker batch is an explicit leading dimension where the JAX package
  used ``vmap``;
* every tensor is created with an explicit ``dtype`` and ``device``: the
  phase path is ``torch.float64`` (the JAX package turns on x64 globally),
  the amplitude projection and the dense pass are ``torch.float32``;
* an entry point runs on the ``device`` it is given, else on its tensor
  arguments' device, else on the current CUDA device
  (``utils/device.py::resolve_device``); without a CUDA device it raises
  unless ``device="cpu"`` (or CPU tensors) says to run on the CPU;
* the one hand-written kernel, the banded FD dense pass, lives in
  ``csrc/fd_dense.cu`` and is wrapped by ``ops/fd_dense.py``; on CPU tensors
  the wrapper runs its plain PyTorch version.

Ported so far: the batched FD waveform path from `waveform_prologue` through
`fd_waveform_core`, with the flat physics (Peters-Mathews flux, plain
multipole amplitudes) and the production physics (the multipole flux grid
with tail, factorized and rwz amplitudes), on the banded uniform-grid kernel
and on the general sorted-grid kernel that checks it; the adaptive DP5 and
the parallel-in-time quadrature trajectories (``method="dp5"`` /
``"quad"``); the TD path and the waveform facades; the parameter-estimation
loop (``lisa/``, ``inference/``, ``cli/emri_pe.py``: whitened likelihood,
tempered stretch-move sampler, chain backends); the TD-vs-FD scan
(``cli/check_mode_by_mode.py``); the Kerr geodesics and the reference's
utility and class facades (``models/utility.py``, ``EMRIInspiral``,
``NewtonianAmplitude``, ``ModeSelector``, ``GetYlms``,
``CubicSplineInterpolant``).
"""

__version__ = "0.1.0"
