"""Packaging of the port: every source that ``plumekit_torch`` builds at
run time (the CUDA sources and headers of ``csrc/``, the C++ of
``native/``) matches a ``package-data`` glob of ``pyproject.toml``, so that
an installed, non-editable package can build every kernel and the host
library."""

import fnmatch
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "plumekit_torch")


def _globs():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"]["plumekit_torch"]


def _sources():
    out = []
    for sub in ("csrc", "native"):
        for name in sorted(os.listdir(os.path.join(PACKAGE, sub))):
            if not name.endswith((".py", ".pyc")) and os.path.isfile(
                    os.path.join(PACKAGE, sub, name)):
                out.append(f"{sub}/{name}")
    return out


def test_every_built_source_is_package_data():
    globs = _globs()
    sources = _sources()
    missing = [s for s in sources
               if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not missing, f"not shipped by {globs}: {missing}"
    # the headers the conv sources include, and the host library's C++
    assert "csrc/conv_tiles.cuh" in sources
    assert {"native/ccl.cpp", "native/quant.cpp"} <= set(sources)


def test_every_included_header_is_beside_its_source():
    import re

    for s in _sources():
        if not s.startswith("csrc/"):
            continue
        with open(os.path.join(PACKAGE, s)) as f:
            for header in re.findall(r'#include "([^"]+)"', f.read()):
                assert os.path.exists(os.path.join(PACKAGE, "csrc", header)), \
                    (s, header)
