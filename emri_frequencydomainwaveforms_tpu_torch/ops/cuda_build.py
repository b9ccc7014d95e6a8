"""Build a CUDA source of the port's ``csrc/`` into a shared library.

Each source is compiled by nvcc for sm_90a, with a plain C interface, into
the package's ``_build/`` directory (gitignored), keyed by a hash of the
source, once per process; the caller loads it with ctypes. `build_all`
starts one nvcc per source at once, so that a process that needs every
kernel (``chip_smoke.py``, the parent of a multi-rank run) waits for the
slowest build only.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("fd_dense", "row_ops", "dp5_inspiral")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a (once per source hash).

    Returns (path of the shared library, compiler log: ptxas's registers and
    spills, or "cached").
    """
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, "cached"
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp_path, source,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_path, lib_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return lib_path, proc.stdout + proc.stderr


def build_all() -> dict[str, tuple[str, str]]:
    """`build` every source of ``csrc/`` at once: {name: (path, log)}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


__all__ = ["build", "build_all", "SOURCES", "CSRC_DIR", "BUILD_DIR"]
