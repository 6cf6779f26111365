"""Builds the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), loaded with
``ctypes``. Libraries land in ``mcpx_torch/_build/`` (or ``$MCPX_TORCH_BUILD_DIR``)
under a name that carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at import
time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from mcpx_torch.core.errors import EngineError

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds and compiler output of the builds this process ran, by kernel name.
build_log: dict[str, dict] = {}


def build_dir() -> str:
    d = os.environ.get("MCPX_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "_build",
    )
    os.makedirs(d, exist_ok=True)
    return d


def kernel_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise EngineError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}_{digest}.so")


def _start(name: str) -> Optional[tuple[subprocess.Popen, str, str, float]]:
    out = library_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.monotonic()


def _finish(name: str, job: tuple[subprocess.Popen, str, str, float]) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise EngineError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_log[name] = {"seconds": time.monotonic() - t0, "log": log}


def build_all(names: Optional[list[str]] = None) -> dict[str, str]:
    """Compile every kernel (one ``nvcc`` per source, all started together)
    and return {name: library path}."""
    names = names or kernel_names()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if this source has no build yet."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _loaded.get(name) or ctypes.CDLL(path)
            _loaded[name] = lib
    return lib
