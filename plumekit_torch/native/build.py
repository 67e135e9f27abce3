"""Build the host library of ``plumekit_torch/native`` with ``g++``.

``ccl.cpp`` and ``quant.cpp`` compile into one shared library with a plain
C interface, loaded with :mod:`ctypes`. It lands in the build directory of
the CUDA kernels (:data:`plumekit_torch.cuda_build.BUILD_DIR`), named by a
hash of the sources, the flags and the host's CPU, so an edited source
rebuilds and an unchanged one loads at once. The flags are the JAX
package's: ``-march=native`` (the library is built on the host that runs
it, at first use) and no ``-ffast-math``, because the codec is bit for bit
the numpy one.

``python -m plumekit_torch.native.build`` builds it and prints its path.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

from plumekit_torch.cuda_build import BUILD_DIR

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "ccl.cpp", HERE / "quant.cpp")
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

#: seconds of this process's compile (None: it found the library built)
BUILD_SECONDS = None
_LOCK = threading.Lock()


def _host_tag() -> str:
    """What ``-march=native`` compiles for: the machine and its CPU's
    feature flags, so that a build directory copied to another host does
    not load a library built for other instructions."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        flags = ""
    return platform.machine() + (flags or platform.processor())


def lib_path() -> Path:
    """The library's path, named by a hash of the sources, the flags and
    the host's CPU."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_host_tag().encode())
    return BUILD_DIR / f"libplumekit_native-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if its hash has none yet; returns its path.
    Threads of one process wait on a lock, processes on a file lock, and
    the library appears by an atomic rename, so no reader loads half of
    one."""
    global BUILD_SECONDS
    path = lib_path()
    if path.exists():
        return str(path)
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "libplumekit_native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                                *map(str, SOURCES)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, path)
                BUILD_SECONDS = time.perf_counter() - t0
    return str(path)


if __name__ == "__main__":
    print(build())
