"""plumekit_torch imports neither JAX nor the JAX package: the machine with
the card has no jax, flax, orbax, pandas, matplotlib or h5py (which the
review export, the quicklooks, ``--plot``, the report's figure and the
``.h5`` readers and writers import when they run, not at import). Every
module is imported, the new ones of each slice named in ``needed``, and
none may load matplotlib. Checked in a fresh interpreter, because this
test process has JAX loaded (tests/conftest.py). ``tools/orbax_to_torch.py``
is outside the package and imports JAX by design."""

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
          "plumekit_torch.experiments.ccl_pass_times",
          "plumekit_torch.models.losses", "plumekit_torch.models.flops",
          "plumekit_torch.train.state", "plumekit_torch.train.augment",
          "plumekit_torch.train.step", "plumekit_torch.train.data",
          "plumekit_torch.train.device_data", "plumekit_torch.train.loop",
          "plumekit_torch.train.checkpoint", "plumekit_torch.data.make_dataset",
          "plumekit_torch.models.kernels.int8_conv",
          "plumekit_torch.models.kernels.int8_upsample",
          "plumekit_torch.models.quantized_forward",
          "plumekit_torch.experiments.int8_conv_times",
          "plumekit_torch.experiments.int8_variants",
          "plumekit_torch.ops.quant", "plumekit_torch.io.prefetch",
          "plumekit_torch.infer.streaming", "plumekit_torch.infer.tta",
          "plumekit_torch.models.unetpp", "plumekit_torch.io.tables",
          "plumekit_torch.label.selector", "plumekit_torch.label.ranking",
          "plumekit_torch.train.curated", "plumekit_torch.train.evaluate",
          "plumekit_torch.train.distill", "plumekit_torch.infer.serve",
          "plumekit_torch.infer.tune", "plumekit_torch.infer.export",
          "plumekit_torch.geo.utm", "plumekit_torch.io.viirs",
          "plumekit_torch.io.viirs_aod", "plumekit_torch.io.verify",
          "plumekit_torch.parallel", "plumekit_torch.parallel.mesh",
          "plumekit_torch.parallel.halo",
          "plumekit_torch.parallel.data_parallel",
          "plumekit_torch.parallel.launch", "plumekit_torch.infer.sharded",
          "plumekit_torch.identify.batch", "plumekit_torch.utils",
          "plumekit_torch.utils.logging", "plumekit_torch.utils.metrics",
          "plumekit_torch.utils.timers", "plumekit_torch.utils.debugging",
          "plumekit_torch.native", "plumekit_torch.native.build",
          "plumekit_torch.viz", "plumekit_torch.viz.plots",
          "plumekit_torch.viz.report", "plumekit_torch.entry",
          "plumekit_torch.experiments.profiler_sessions",
          "plumekit_torch.io.hdf4"}
banned = {"jax", "jaxlib", "flax", "orbax", "pandas", "plumekit",
          "matplotlib", "h5py"}
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


HDF_PROBE = """
import sys
sys.modules["pyhdf"] = None          # any import of it fails
from plumekit_torch.io.granule import load_granule
g = load_granule("tests/data/maiac/maiac_chunked_deflate.hdf")
assert list(g.layers) == ["20172131535T", "20172131710A"], list(g.layers)
with open("/proc/self/maps") as f:
    maps = [line for line in f if "libdfalt" in line or "libmfhdf" in line]
banned = {"pyhdf", "jax", "jaxlib", "plumekit"}
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in banned and sys.modules[m] is not None)
print("libraries:", maps, "loaded:", loaded)
sys.exit(1 if maps or loaded else 0)
"""


def test_hdf_granules_read_without_pyhdf_or_the_hdf4_library():
    """A ``.hdf`` fixture through ``load_granule`` in a fresh interpreter
    where ``pyhdf`` cannot be imported: no HDF4 C library is mapped and
    none of pyhdf, jax or plumekit is imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", HDF_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
