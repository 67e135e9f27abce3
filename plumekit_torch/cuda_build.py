"""Build the hand-written CUDA kernels of ``plumekit_torch/csrc`` at first use.

Each ``.cu`` file there is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
library lands in ``build/plumekit_torch/`` beside the package, named by a
hash of its source and of the headers (``*.cuh``) beside it, so an edited
source or header rebuilds and an unchanged one loads at once.
:func:`load_libraries` compiles several sources side by side. Nothing here
runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

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


def _lib_path(source: str) -> Path:
    """The library of ``csrc/<source>``, named by a hash of the source, of
    every header beside it (a source may include any of them, and an edited
    header must not load a stale library) and of the compiler flags."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def load_libraries(sources: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile each ``csrc/<source>`` whose hash has no library yet, one
    ``nvcc`` per source, all started together, then load every library."""
    sources = list(sources)
    builds = []
    for source in sources:
        if source in _LOADED:
            continue
        lib_path = _lib_path(source)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        builds.append((source, proc, tmp, lib_path, time.perf_counter()))
    failed = []
    for source, proc, tmp, lib_path, t0 in builds:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {CSRC_DIR / source}:\n{err}")
            continue
        os.replace(tmp, lib_path)
        BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                             "ptxas": err}
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in sources:
        if source not in _LOADED:
            _LOADED[source] = ctypes.CDLL(str(_lib_path(source)))
    return {source: _LOADED[source] for source in sources}


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if its hash has no library yet) and load
    it. Every kernel launch comes through here, so a library that is
    already loaded is returned without reading or hashing its source."""
    lib = _LOADED.get(source)
    return lib if lib is not None else load_libraries([source])[source]


def load_entry(source: str, entry: str, argtypes) -> ctypes.CDLL:
    """The library of ``csrc/<source>`` with the signature of its launch
    function ``entry`` set: ``argtypes`` in, a ``cudaError_t`` out, which
    the library's ``pk_error_string`` turns into text."""
    lib = load_library(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.pk_error_string.argtypes = [ctypes.c_int]
        lib.pk_error_string.restype = ctypes.c_char_p
    return lib
