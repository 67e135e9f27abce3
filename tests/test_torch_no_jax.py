"""plumekit_torch imports neither JAX nor the JAX package: the machine with
the card has no jax, flax, orbax or pandas. Checked in a fresh interpreter,
because this test process has JAX loaded (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import plumekit_torch
names = [m.name for m in pkgutil.walk_packages(plumekit_torch.__path__,
                                               "plumekit_torch.")]
for name in names:
    importlib.import_module(name)
needed = {"plumekit_torch.models.kernels.unet_mega",
          "plumekit_torch.models.kernels.fused_conv",
          "plumekit_torch.experiments.scalar_gather_probe",
          "plumekit_torch.experiments.ccl_pass_times"}
banned = {"jax", "jaxlib", "flax", "orbax", "pandas", "plumekit"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
missing = sorted(needed - set(names))
print(len(names), "modules;", "loaded:", loaded, "missing:", missing)
sys.exit(1 if loaded or missing or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_flax_orbax_pandas_or_plumekit():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
