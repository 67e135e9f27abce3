"""Build the hand-written CUDA kernels of ``plumekit_torch/csrc`` at first use.

Each ``.cu`` file there is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
library lands in ``build/plumekit_torch/`` beside the package, named by a
hash of its source, so an edited source rebuilds and an unchanged one loads
at once. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "plumekit_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: what each build printed and how long it took, by source name
BUILD_LOG: dict = {}
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of plumekit_torch "
                       "build only where the CUDA toolkit is installed")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if its hash has no library yet) and load it."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                             "ptxas": proc.stderr}
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[source] = lib
    return lib
