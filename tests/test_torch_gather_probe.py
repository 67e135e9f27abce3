"""plumekit_torch's gather probe (P1) against the JAX package's
``experiments/scalar_dma_probe.py``. That script parses its arguments and
runs when it is imported, so it is run whole in a fresh interpreter, its
Pallas kernel in interpret mode (``--cpu``), and the plane it made and the
plane its kernel returned are brought back; the port's entry must return the
same plane from the same input. The script takes square planes only, so its
four lines of index arithmetic (:50-51, :99-106) are restated here for the
others, and the restatement is held against the script's kernel too. On the
CPU the port runs the probe's plain version; the two CUDA forms are held
against it on the card by tests/test_torch_kernels_cuda.py and
``chip_smoke.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plumekit_torch.experiments import scalar_gather_probe as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "experiments", "scalar_dma_probe.py")
# runs the script as ``python experiments/scalar_dma_probe.py --cpu --size S
# --reps N`` would, keeps it from pointing JAX's compilation cache at a
# directory outside the test's own, and saves its input and its kernel's
# output
RUNNER = """
import runpy, sys
import numpy as np
import jax
update = jax.config.update
jax.config.update = lambda key, value: (
    None if key == "jax_compilation_cache_dir" else update(key, value))
script, out, size, reps = sys.argv[1:]
sys.argv = [script, "--cpu", "--size", size, "--reps", reps]
ns = runpy.run_path(script)
np.savez(out, x=ns["x"], got=ns["got"], expected=ns["expected"])
"""


def _jax_probe(tmp_path, size, reps):
    """(input plane, the Pallas kernel's output, the script's own numpy
    loop) of one run of the JAX probe, and what it printed."""
    out = str(tmp_path / "probe.npz")
    done = subprocess.run(
        [sys.executable, "-c", RUNNER, SCRIPT, out, str(size), str(reps)],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert done.returncode == 0, done.stderr[-2000:]
    with np.load(out) as f:
        return f["x"], f["got"], f["expected"], done.stdout


def _expected(x, n):
    """``scalar_dma_probe.py:48-51, 99-106`` for an (H, W) plane."""
    h, w = x.shape
    stride_r = max(1, h // 32)
    stride_c = max(1, w // (n // 32))
    expected = x.copy()
    for i in range(n):
        r = (i // (n // 32)) * stride_r
        c = (i % (n // 32)) * stride_c
        v = x[r, c]
        expected[r, c] = x[v // w, v % w]
    return expected


@pytest.mark.parametrize("size,n", [
    (1024, 1024),           # the probe's defaults
    (256, 1024), (128, 64), (64, 2048)])
def test_plain_version_matches_the_jax_probes_kernel(tmp_path, size, n):
    x, want, loop, printed = _jax_probe(tmp_path, size, n)
    assert "exact: True" in printed
    assert x.shape == (size, size) and (want != x).any()
    got = probe.gather_probe(torch.from_numpy(x), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probe.numpy_loop(x, n), want)
    np.testing.assert_array_equal(_expected(x, n), loop)
    # the port's entry makes the same plane from the same seed
    same = np.random.default_rng(0).integers(0, size * size, (size, size))
    np.testing.assert_array_equal(same.astype(np.int32), x)


@pytest.mark.parametrize("h,w,n", [
    (1024, 1024, 1024),     # the probe's defaults
    (256, 256, 1024), (100, 100, 64), (64, 257, 32), (40, 2000, 2048),
    (32, 32, 32)])
def test_plain_version_matches_the_probes_loop(h, w, n):
    x = np.random.default_rng(0).integers(0, h * w, (h, w)).astype(np.int32)
    want = _expected(x, n)
    got = probe.gather_probe(torch.from_numpy(x), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probe.numpy_loop(x, n), want)
    assert (got.numpy() != x).sum() <= n


def test_probe_refuses_what_does_not_fit():
    x = torch.zeros((64, 64), dtype=torch.int32)
    for n in (0, 31, 40):
        with pytest.raises(ValueError, match="multiple of 32"):
            probe.gather_probe(x, n)
    with pytest.raises(ValueError, match="do not fit"):
        probe.gather_probe(torch.zeros((16, 64), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="do not fit"):
        probe.gather_probe(x, 64 * 64)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(probe, "_library", refuse)
    x = torch.arange(64 * 64, dtype=torch.int32).reshape(64, 64).flip(0)
    before = probe.CHAINED_LAUNCHES, probe.PARALLEL_LAUNCHES
    out = probe.gather_probe(x, 64, chained=True)
    assert torch.equal(out, probe.gather_probe_ref(x, 64))
    assert (probe.CHAINED_LAUNCHES, probe.PARALLEL_LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        probe.gather_probe(x.to("meta"), 64)


def test_main_checks_the_plain_version_on_the_cpu(capsys, tmp_path):
    """The port's entry and the JAX script at the same size, lookups and
    seed: both print ``exact: True``."""
    assert "exact: True" in _jax_probe(tmp_path, 128, 64)[3]
    assert probe.main(["--device", "cpu", "--size", "128", "--reps",
                       "64"]) == 0
    assert "plain: exact: True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert probe.main(["--size", "128", "--reps", "64"]) == 1
