"""Convert a checkpoint of the JAX trainer into one that plumekit_torch
serves.

Usage::

    python tools/orbax_to_torch.py CKPT_DIR OUT_DIR [--step N]

``CKPT_DIR`` is a directory that ``plumekit train_model`` wrote: orbax
``step_<8 digits>`` directories and ``model_config.json``. The latest step
(``plumekit.train.checkpoint.latest_step``, which ignores ``.tmp``
directories), or step N, is restored through the JAX package's own
reader; its ``params`` and ``batch_stats`` are carried to a U-Net or
UNet++ ``state_dict`` by ``plumekit_torch.convert.from_flax`` and written
as ``OUT_DIR/weights.pt`` by the port's ``save_weights``, with
``model_config.json`` copied beside it. Then ``plumekit-torch
predict_model --checkpoint OUT_DIR`` (or ``serve``, ``evaluate_model``, a
``--distill-from`` teacher) serves it.

The script needs JAX, flax and orbax-checkpoint, with the ``plumekit``
package, so it runs where the JAX trainer ran, not on a machine with the
port alone. It lives outside ``plumekit_torch``, which imports none of
them. The optimizer state is not carried: the port does not resume a JAX
run's training. Nothing is written into ``CKPT_DIR``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def convert(ckpt_dir: str, out_dir: str, step=None) -> int:
    """Restore step ``step`` (default: the latest) of ``ckpt_dir`` and
    write the port's checkpoint into ``out_dir``; returns the step."""
    import jax
    import numpy as np

    from plumekit.train.checkpoint import latest_step, restore_checkpoint
    from plumekit_torch.convert import from_flax
    from plumekit_torch.models import build_model
    from plumekit_torch.config import UNetConfig
    from plumekit_torch.train.checkpoint import load_model_config, save_weights

    if os.path.abspath(out_dir) == os.path.abspath(ckpt_dir):
        raise ValueError("OUT_DIR must differ from CKPT_DIR: nothing is "
                         "written into the JAX checkpoint directory")
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None or not os.path.isdir(
            os.path.join(ckpt_dir, f"step_{step:08d}")):
        raise ValueError(f"no orbax step directory "
                         f"{'step_%08d' % step if step is not None else ''}"
                         f" under {ckpt_dir!r}")
    # no target: orbax restores the saved tree as a plain dict (and warns)
    restored = restore_checkpoint(ckpt_dir, None, step)
    variables = {"params": restored["params"]}
    if restored.get("batch_stats") is not None:
        variables["batch_stats"] = restored["batch_stats"]
    variables = jax.tree.map(np.asarray, variables)

    cfg = load_model_config(ckpt_dir) or UNetConfig()
    model = build_model(cfg)
    # strict: every tensor of the port's model must come from the step
    model.load_state_dict(from_flax(variables))
    os.makedirs(out_dir, exist_ok=True)
    save_weights(out_dir, model)
    src = os.path.join(ckpt_dir, "model_config.json")
    if os.path.exists(src):
        shutil.copyfile(src, os.path.join(out_dir, "model_config.json"))
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="orbax_to_torch",
        description="Convert a plumekit (JAX) orbax checkpoint directory "
                    "into plumekit_torch's weights.pt and model_config.json. "
                    "Needs jax, flax, orbax-checkpoint and plumekit. The "
                    "optimizer state is not carried: the port does not "
                    "resume a JAX run's training.")
    p.add_argument("ckpt_dir", help="the JAX trainer's checkpoint directory "
                                    "(orbax step_* directories)")
    p.add_argument("out_dir", help="directory to write weights.pt and "
                                   "model_config.json into")
    p.add_argument("--step", type=int, default=None,
                   help="step to convert (default: the latest)")
    args = p.parse_args(argv)
    try:
        step = convert(args.ckpt_dir, args.out_dir, args.step)
    except ValueError as e:
        print(f"orbax_to_torch: {e}", file=sys.stderr)
        return 1
    print(f"step {step} of {args.ckpt_dir} -> "
          f"{os.path.join(args.out_dir, 'weights.pt')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
