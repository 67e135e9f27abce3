"""Command-line entry points of the port: ``build_features`` and
``predict_model``.

Usage: ``plumekit-torch <command> --root R ...`` or
``python -m plumekit_torch.cli <command> ...``. Both read the granules
under ``<root>/raw/plume_identification/maiac``:

* ``build_features --detector rg`` writes ``<base>_aod.csv`` and
  ``<base>_extent.csv`` under ``raw/plume_identification/dataframes/full``
  and ``<base>_masks.npz`` under ``interim/plume_masks``, resuming through
  ``raw/plume_identification/logs/rg_log.txt``, as ``plumekit
  build_features`` does;
* ``predict_model`` writes ``<root>/processed/predictions/<name>_pred.npz``
  (``probs``, ``mask``, ``threshold``) as ``plumekit predict_model`` does.

The device is the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from plumekit_torch.config import InferConfig, PathsConfig, UNetConfig
from plumekit_torch.device import resolve_device
from plumekit_torch.utils import get_logger

#: calibrated serving threshold artifact under <root>/models/
THRESHOLD_BASENAME = "threshold.json"

#: serving flags of the JAX CLI that this port does not serve yet, with the
#: ROADMAP.md item (queue A) that ports each
UNPORTED_FLAGS = {
    "int8": "int8 forward",
    "exported": "exported serving artifacts",
    "tta": "test-time augmentation",
    "mesh_devices": "multi-card serving",
    "tuned": "serving geometry tuner",
    "prune_level": "UNet++",
    "quantize": "quantized transfers",
    "quantize_output": "quantized transfers",
    "plot": "prediction quicklooks",
}

logger = get_logger("plumekit_torch.cli")


class _CliError(Exception):
    """Usage or configuration error: the message is logged, exit code 1."""


def _restore_model(args, device):
    """Build the U-Net of ``model_config.json`` (default config if absent)
    and load ``weights.pt``; with no weights, warn and keep seeded
    untrained weights."""
    from plumekit_torch.models import build_model
    from plumekit_torch.train.checkpoint import (has_orbax_steps,
                                                 load_model_config,
                                                 load_weights)

    ckpt_dir = args.checkpoint or os.path.join(
        args.root, PathsConfig().model_dir, "checkpoints")
    unet_cfg = load_model_config(ckpt_dir) or UNetConfig()
    try:
        model = build_model(unet_cfg, torch.Generator().manual_seed(0))
    except NotImplementedError as e:
        raise _CliError(str(e))
    if load_weights(ckpt_dir, model):
        logger.info("restored weights from %s", ckpt_dir)
    elif has_orbax_steps(ckpt_dir):
        raise _CliError(
            f"{ckpt_dir} holds orbax step_* checkpoints of the JAX trainer, "
            "which plumekit_torch does not read yet (ROADMAP.md, queue A: "
            "'orbax checkpoint import'); convert them with "
            "plumekit_torch.convert.from_flax")
    else:
        logger.warning("no weights found in %s — using untrained weights",
                       ckpt_dir)
    return unet_cfg, model.to(device).eval()


def _build_serving(args, unet_cfg, threshold: float):
    """The multi-granule inference program of the chosen forward."""
    from plumekit_torch.infer import make_multi_granule_infer

    if args.fused:
        if unet_cfg.arch != "unet":
            raise _CliError("--fused supports the unet architecture only; "
                            f"checkpoint is {unet_cfg.arch}")
        from plumekit_torch.models.fused_forward import make_fused_apply

        try:
            apply_fn = make_fused_apply(unet_cfg)
        except ValueError as e:
            raise _CliError(f"--fused: {e}")
    else:
        def apply_fn(model, x):
            return model(x)
    icfg = InferConfig(tile_size=args.tile, overlap=args.overlap,
                       batch_tiles=args.batch_tiles, threshold=threshold)
    return make_multi_granule_infer(apply_fn, icfg,
                                    channels=unet_cfg.in_channels)


def _resolve_threshold(args) -> float:
    """``--threshold`` wins; else ``<root>/models/threshold.json`` if
    present and readable; else 0.5."""
    if args.threshold is not None:
        return float(args.threshold)
    path = os.path.join(args.root, PathsConfig().model_dir,
                        THRESHOLD_BASENAME)
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
            t = float(payload["threshold"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            logger.warning("%s unreadable (%s) — serving threshold 0.5",
                           path, e)
            return 0.5
        logger.info("serving calibrated threshold %.2f from %s (dev %s="
                    "%s; --threshold 0.5 restores the default)", t, path,
                    payload.get("metric"), payload.get("value"))
        return t
    return 0.5


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _sweep_stale_tmps(out_dir) -> None:
    """Remove atomic-write temporaries left by a crashed writer; a tmp whose
    pid is alive belongs to a running writer and stays."""
    for f in os.listdir(out_dir):
        if f.startswith(".") and ".tmp" in f and f.endswith(".npz"):
            try:
                pid = int(f.rsplit(".tmp", 1)[1][:-len(".npz")])
            except ValueError:
                continue
            if _pid_alive(pid):
                continue
            try:
                os.remove(os.path.join(out_dir, f))
            except OSError:
                pass


def _write_prediction(out_dir, name, probs, threshold=0.5):
    """Atomically write ``<name>_pred.npz`` with the mask thresholded here,
    from the fp32 probs."""
    out = os.path.join(out_dir, name + "_pred.npz")
    tmp = os.path.join(out_dir, f".{name}_pred.tmp{os.getpid()}.npz")
    mask = probs > threshold
    np.savez_compressed(tmp, probs=probs, mask=mask,
                        threshold=np.float32(threshold))
    os.replace(tmp, out)
    logger.info("%s: %.1f%% plume pixels (threshold %.2f)", out,
                100.0 * float(mask.mean()), threshold)
    return out


def cmd_predict_model(args) -> int:
    """Sliding-window inference over granules → plume-probability NPZs."""
    from plumekit_torch.infer.streaming import stream_inference
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS

    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            logger.error("--%s is not ported to plumekit_torch yet "
                         "(ROADMAP.md, queue A: '%s')",
                         flag.replace("_", "-"), item)
            return 1
    paths = PathsConfig(root=args.root)
    threshold = _resolve_threshold(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    try:
        unet_cfg, model = _restore_model(args, device)
        infer = _build_serving(args, unet_cfg, threshold)
    except _CliError as e:
        logger.error("%s", e)
        return 1

    out_dir = paths.ensure("predictions_dir")
    maiac_dir = paths.ensure("maiac_dir")
    _sweep_stale_tmps(out_dir)
    granule_paths = [os.path.join(maiac_dir, f)
                     for f in sorted(os.listdir(maiac_dir))
                     if f.endswith(GRANULE_EXTENSIONS)]
    with torch.inference_mode():
        for name, probs in stream_inference(
                granule_paths, infer, model, unet_cfg.depth, device,
                batch_granules=args.batch_granules):
            _write_prediction(out_dir, name, probs, threshold=threshold)
    return 0


#: build_features options of the JAX CLI that this port does not run yet,
#: with the ROADMAP.md item (queue A) that ports each
UNPORTED_DETECTORS = {"gaussian": "11. The other detectors",
                      "basic": "11. The other detectors"}


def cmd_build_features(args) -> int:
    """Identify plumes in every granule with the rg detector → per-granule
    ``_aod.csv``, ``_extent.csv`` and ``_masks.npz``, resumable through the
    work log (the reference's ``plume_identifier_rg.main()`` loop)."""
    from plumekit_torch.config.identify import RGIdentifyConfig
    from plumekit_torch.identify import rg as rg_mod
    from plumekit_torch.io.dates import granule_date
    from plumekit_torch.io.fires import load_fire_csv, n_fires
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS, load_granule
    from plumekit_torch.train.checkpoint import WorkLog

    if args.detector in UNPORTED_DETECTORS:
        logger.error("--detector %s is not ported to plumekit_torch yet "
                     "(ROADMAP.md, queue A: '%s')", args.detector,
                     UNPORTED_DETECTORS[args.detector])
        return 1
    if args.batch_scenes < 1:
        logger.error("--batch-scenes must be >= 1, got %d", args.batch_scenes)
        return 1
    if args.batch_scenes > 1:
        logger.error("--batch-scenes > 1 is not ported to plumekit_torch yet "
                     "(ROADMAP.md, queue A: '12. Multi-scene identify')")
        return 1
    if args.plot:
        logger.error("--plot is not ported to plumekit_torch yet (ROADMAP.md,"
                     " queue A: '20. Prediction quicklooks')")
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1

    paths = PathsConfig(root=args.root)
    maiac_dir = paths.ensure("maiac_dir")
    log = WorkLog(os.path.join(paths.ensure("log_dir"),
                               f"{args.detector}_log.txt"))
    fire_csv = os.path.join(paths.resolve("fires_dir"), "fires.csv")
    if not os.path.exists(fire_csv):
        logger.error("no fire table at %s — place a VIIRS fire CSV there",
                     fire_csv)
        return 1
    fires = load_fire_csv(fire_csv)
    default_date = fires["date_time"][0] if n_fires(fires) else None
    aod_dir = paths.ensure("aod_df_dir")
    hull_dir = paths.ensure("hull_df_dir")

    done = log.items()
    n_done = 0
    for fname in sorted(os.listdir(maiac_dir)):
        if not fname.endswith(GRANULE_EXTENSIONS):
            continue
        if fname in done:
            logger.info("%s already processed, continuing...", fname)
            continue
        granule = load_granule(os.path.join(maiac_dir, fname))
        # MAIAC names carry the acquisition date; synthetic granules fall
        # back to the fire table's first date
        date = granule_date(fname, default=default_date)
        aod_table, hull_table, out = rg_mod.identify(
            granule.first_layer(), granule.lat, granule.lon, date, fires,
            RGIdentifyConfig(), device=device)
        base = os.path.splitext(fname)[0]
        aod_table.to_csv(os.path.join(aod_dir, base + "_aod.csv"))
        if not args.no_masks:
            masks = rg_mod.plume_masks(out)
            if masks:
                np.savez_compressed(
                    os.path.join(paths.ensure("plume_mask_dir"),
                                 base + "_masks.npz"),
                    **{str(pid): m for pid, m in masks.items()})
        # the hull CSV last: the log and the CSV mark a granule as done
        hull_table.to_csv(os.path.join(hull_dir, base + "_extent.csv"))
        log.mark(fname)
        n_done += 1
        logger.info("%s: %d plumes", base, len(set(hull_table.column("id"))))
    logger.info("processed %d granules", n_done)
    return 0


def _add_serving_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                   help="workspace root")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda; the "
                        "CPU runs the kernels' plain versions)")
    p.add_argument("--checkpoint", default=None,
                   help="directory of model_config.json and weights.pt "
                        "(default <root>/models/checkpoints)")
    p.add_argument("--tile", type=int, default=288)
    p.add_argument("--overlap", type=int, default=32,
                   help="blended tile overlap; 0 = disjoint tiling")
    p.add_argument("--fused", action="store_true",
                   help="forward through the hand-written fused "
                        "double-conv CUDA kernel at every U-Net block")
    p.add_argument("--threshold", type=float, default=None,
                   help="mask threshold (default: <root>/models/"
                        "threshold.json if present, else 0.5)")
    p.add_argument("--batch-granules", type=int, default=2,
                   help="same-shape granules per forward group "
                        "(1 = per granule)")
    p.add_argument("--batch-tiles", type=int, default=64,
                   help="tiles per forward and granule")
    unported = " (not ported yet: exits 1)"
    p.add_argument("--plot", action="store_true", help="quicklook PNG"
                   + unported)
    p.add_argument("--int8", action="store_true", help="int8 forward"
                   + unported)
    p.add_argument("--tta", action="store_true",
                   help="D4 test-time augmentation" + unported)
    p.add_argument("--quantize", action="store_true",
                   help="uint16 host-to-device payloads" + unported)
    p.add_argument("--quantize-output", action="store_true",
                   help="uint8 probability readback" + unported)
    p.add_argument("--exported", default=None,
                   help="serve an exported artifact" + unported)
    p.add_argument("--prune-level", type=int, default=None,
                   help="UNet++ pruned serving" + unported)
    p.add_argument("--mesh-devices", type=int, default=0, metavar="D",
                   help="multi-card serving" + unported)
    p.add_argument("--tuned", nargs="?", const="auto", default=None,
                   metavar="JSON", help="tuned serving geometry" + unported)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="plumekit-torch")
    sub = p.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("predict_model", help="sliding-window inference")
    _add_serving_args(pr)
    pr.set_defaults(fn=cmd_predict_model)

    bf = sub.add_parser("build_features",
                        help="rg weak labeller over every granule → CSVs "
                             "and plume masks")
    bf.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    bf.add_argument("--detector", choices=["rg", "gaussian", "basic"],
                    default="rg",
                    help="detector (only rg is ported; the others exit 1)")
    bf.add_argument("--device", default="cuda",
                    help="torch device of the sweep (default: cuda; the CPU "
                         "runs the kernels' plain versions)")
    bf.add_argument("--no-masks", action="store_true",
                    help="skip the per-plume mask npz (hull CSVs only)")
    bf.add_argument("--batch-scenes", type=int, default=1,
                    help="scenes per sweep (only 1 is ported; more exits 1)")
    bf.add_argument("--plot", action="store_true",
                    help="annotated scene PNGs (not ported yet: exits 1)")
    bf.set_defaults(fn=cmd_build_features)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
