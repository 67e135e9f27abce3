"""Command-line entry points of the port: ``make_dataset``,
``resample_viirs``, ``identify_viirs``, ``build_features``, ``identify``,
``verify_real_granule``, ``select``, ``prepare_model_data``,
``train_model``, ``predict_model``, ``serve``, ``tune``,
``export_model``, ``evaluate_model`` and ``report``.

Usage: ``plumekit-torch <command> --root R ...`` or
``python -m plumekit_torch.cli <command> ...``. ``build_features`` and
``predict_model`` read the granules under
``<root>/raw/plume_identification/maiac``:

* ``build_features --detector rg`` writes ``<base>_aod.csv`` and
  ``<base>_extent.csv`` under ``raw/plume_identification/dataframes/full``
  and ``<base>_masks.npz`` under ``interim/plume_masks``, resuming through
  ``raw/plume_identification/logs/rg_log.txt``, as ``plumekit
  build_features`` does; ``--batch-scenes G`` identifies groups of G
  same-shape granules. ``--detector basic`` writes one bounding-box row
  per plume and ``--detector gaussian`` the hull vertices of every orbit
  layer with a ``datetime`` column, both to ``<base>_extent.csv``, each
  with a work log of its own;
* ``identify GRANULE FIRES --detector D`` prints one granule's
  plume count and, with ``--out``, writes its hull table;
* ``make_dataset`` writes synthetic granules under
  ``raw/plume_identification/maiac`` and their fires to
  ``raw/fires/fires.csv``, as ``plumekit make_dataset`` does, and with
  ``--viirs-swaths`` / ``--viirs-aod-pairs`` VIIRS SDR swaths and
  IVAOT/GMTCO h5 pairs with ``raw/fires/fires_viirs_aod.csv``;
* ``resample_viirs`` reprojects the SDR swaths onto UTM grids
  (``raw/reprojected_viirs/h5``) and ``identify_viirs`` resamples every
  IVAOT/GMTCO pair and runs the basic detector on it (``raw/viirs/masks``),
  as the reference notebook does; the files are h5, so both need h5py;
* ``verify_real_granule FILE`` runs one granule through the real-data
  contract register and prints its JSON summary;
* ``select --decisions CSV`` splits every rg or gaussian hull table into
  kept (``dataframes/reduced/plume/hull``) and rejected
  (``dataframes/reduced/not_plume/hull``) plumes; without ``--decisions``
  it writes a review batch (PNGs and ``manifest.csv``) under
  ``<root>/review/<base>``, most-suspect-first with
  ``--rank-with-predictions``, and needs matplotlib;
* ``prepare_model_data`` turns the kept hulls (or their device masks)
  into model-ready samples under ``processed/model_data``;
* ``train_model`` trains the U-Net (``--arch unetpp [--deep-supervision]``:
  the UNet++) on synthetic granules made from ``DataConfig``
  (``--weak-labels``: labelled by the rg detector; ``--curated``: on the
  root's model-ready samples), as ``plumekit train_model`` does,
  optionally relabelled by a teacher checkpoint (``--distill-*``), and
  writes ``model_config.json``, ``weights.pt`` and step checkpoints under
  ``<root>/models/checkpoints`` and the metrics CSV beside them;
* ``predict_model`` writes ``<root>/processed/predictions/<name>_pred.npz``
  (``probs``, ``mask``, ``threshold``) as ``plumekit predict_model`` does;
  ``--prune-level L`` serves a deep-supervised UNet++ checkpoint pruned at
  fusion level L; ``--int8`` serves the int8 forward, calibrated on the
  first granule with signal, through the int8 conv kernels on the card;
  ``--tta`` averages the 8 D4 views of every tile batch, ``--quantize``
  uploads uint16 channels and ``--quantize-output`` reads back uint8
  probabilities. Granules decode on a thread pool and upload on a stager
  thread ahead of the forwards, as in the JAX package; ``build_features``
  decodes on the same pool; ``--tuned`` serves the geometry that ``tune``
  measured; ``--exported DIR`` serves an ``export_model`` artifact;
* ``serve`` watches the granule directory and writes the same prediction
  files for each arrival, with ``served_granules.txt`` and the quarantine
  ``failed_granules.txt`` beside them, as ``plumekit serve`` does;
* ``tune`` times candidate serving geometries of the checkpoint's forward
  on the device and writes the ranked table to
  ``<root>/models/tuned_geometry.json``;
* ``export_model`` traces the serving program of the checkpoint's forward
  (``--int8``, ``--tta``, ``--prune-level``) at a fixed granule geometry
  with ``torch.export`` into ``<root>/models/exported`` (one program per
  platform of ``--platforms``, default ``gpu,cpu``), which ``--exported``
  serves with any checkpoint of the architecture;
* ``evaluate_model`` scores the checkpoint (or ``--predictions``) against
  the model-ready samples: ``processed/evaluation.csv``, plume-level
  counts with ``--objects`` (connected components through the K2 kernel on
  the card), a threshold sweep with ``--sweep-threshold`` and, with
  ``--write-threshold``, ``<root>/models/threshold.json``, which
  ``predict_model`` and ``--distill-calibrate`` read;
* ``report`` writes ``<root>/reports/report.md`` over the stages that have
  run (the training figure where matplotlib is installed).

``--plot`` on ``build_features``, ``predict_model`` and ``serve`` also
writes annotated PNGs; it needs matplotlib, and exits 1 where it is absent
before any granule is decoded.

The device is the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from plumekit_torch.config import InferConfig, PathsConfig, UNetConfig
from plumekit_torch.device import resolve_device
from plumekit_torch.utils import get_logger

#: calibrated serving threshold artifact under <root>/models/
THRESHOLD_BASENAME = "threshold.json"

#: granules the int8 calibration looks at for one with signal
INT8_CALIBRATION_CANDIDATES = 4

logger = get_logger("plumekit_torch.cli")


class _CliError(Exception):
    """Usage or configuration error: the message is logged, exit code 1."""


def _write_json_atomic(path: str, payload: dict) -> None:
    """pid-suffixed temporary and ``os.replace``: readers never see a torn
    file, concurrent writers never share a temporary."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _restore_model(args, device):
    """Build the model of ``model_config.json`` (default config if absent)
    and load ``weights.pt``; with no weights, warn and keep seeded
    untrained weights. With ``--prune-level`` the served config is the
    recorded one pruned at that level (UNet++ serving-time pruning); the
    model holds the full grid all the same, so the checkpoint loads as it
    is and only the forward stops at the level."""
    from plumekit_torch.models import build_model, effective_level
    from plumekit_torch.train.checkpoint import (has_orbax_steps,
                                                 load_model_config,
                                                 load_weights)

    ckpt_dir = args.checkpoint or os.path.join(
        args.root, PathsConfig().model_dir, "checkpoints")
    unet_cfg = load_model_config(ckpt_dir) or UNetConfig()
    if args.prune_level is not None:
        unet_cfg = dataclasses.replace(unet_cfg, prune_level=args.prune_level)
        try:
            effective_level(unet_cfg)
        except ValueError as e:
            raise _CliError(f"--prune-level: {e}")
    try:
        model = build_model(unet_cfg, torch.Generator().manual_seed(0))
    except ValueError as e:
        raise _CliError(str(e))
    if load_weights(ckpt_dir, model):
        logger.info("restored weights from %s", ckpt_dir)
    elif has_orbax_steps(ckpt_dir):
        raise _CliError(
            f"{ckpt_dir} holds orbax step_* checkpoints of the JAX trainer, "
            "which plumekit_torch does not read; convert them where "
            "plumekit is installed with `python tools/orbax_to_torch.py "
            f"{ckpt_dir} OUT_DIR` and pass --checkpoint OUT_DIR")
    else:
        logger.warning("no weights found in %s — using untrained weights",
                       ckpt_dir)
    return unet_cfg, model.to(device).eval()


def _module_forward(model, x):
    """The checkpoint's own forward: cuDNN, K6 under ``use_pallas``, K7
    under ``use_mega`` (the module routes inside)."""
    return model(x)


def _refused(args) -> bool:
    """Log and return True when a flag cannot be served: one that an
    exported program cannot honour beside ``--exported`` (the JAX CLI's
    refusals and messages), or ``--plot`` where matplotlib is absent."""
    if args.exported:
        for flag, message in (
                ("tuned", "--tuned and --exported are mutually exclusive: "
                          "an exported artifact's geometry is baked into "
                          "its program"),
                ("tta", "--tta and --exported are mutually exclusive: the "
                        "exported program's forward is baked in — export "
                        "with `export_model --tta` to ship a TTA artifact"),
                ("mesh_devices", "--mesh-devices and --exported are "
                                 "mutually exclusive: the exported "
                                 "program's device layout is baked in — "
                                 "serve the live model on the mesh "
                                 "instead")):
            if getattr(args, flag):
                logger.error("%s", message)
                return True
    return _plot_refused(args)


def _plot_refused(args) -> bool:
    """``--plot`` where matplotlib is absent: log and return True, before
    any granule is decoded or any device work."""
    from plumekit_torch.viz import matplotlib_present

    if args.plot and not matplotlib_present():
        logger.error("--plot writes PNGs and needs matplotlib, which is not "
                     "installed; drop --plot, or install matplotlib")
        return True
    return False


def _apply_tuned(args, unet_cfg=None) -> None:
    """Resolve ``--tuned`` (bare: ``<root>/models/tuned_geometry.json``)
    into ``--tile``, ``--overlap``, ``--batch-tiles`` and
    ``--batch-granules``, overriding them: the artifact is the measurement
    those flags guess at. Warns, and still applies, when the artifact was
    measured for another forward or architecture."""
    from plumekit_torch.infer.tune import TUNED_BASENAME, load_tuned

    tpath = args.tuned
    if tpath == "auto":
        tpath = os.path.join(args.root, PathsConfig().model_dir,
                             TUNED_BASENAME)
    try:
        payload = load_tuned(tpath)
    except FileNotFoundError:
        raise _CliError(
            f"--tuned: {tpath} not found — run `plumekit tune` first")
    except (OSError, ValueError) as e:
        raise _CliError(f"--tuned: {e}")
    for field, want, label in (
            ("int8", bool(getattr(args, "int8", False)), "forward"),
            ("arch", getattr(unet_cfg, "arch", None), "architecture")):
        have = payload.get(field)
        if have is not None and want is not None and have != want:
            logger.warning(
                "--tuned: artifact was measured with %s=%s but serving "
                "%s=%s — the optimum is %s-dependent, re-run `plumekit "
                "tune` for this configuration", field, have, field, want,
                label)
    best = payload["best"]
    args.tile, args.overlap = best["tile"], best["overlap"]
    args.batch_tiles = best["batch_tiles"]
    args.batch_granules = best["granules"]
    logger.info(
        "tuned geometry from %s (measured %s on %s): tile %d/%d, "
        "batch_tiles %d, G=%d — %.1f MPix/s",
        tpath, payload.get("measured_utc"), payload.get("device_kind"),
        args.tile, args.overlap, args.batch_tiles, args.batch_granules,
        best.get("mpix_s") or float("nan"))


@dataclasses.dataclass
class _Serving:
    """What ``predict_model`` and ``serve`` run: the program, the depth the
    decode pads to, the granules per program (a fixed group when
    ``infer_is_batched``), whether it is the int8 forward and the tile its
    calibration uses, ``variables_of``, which makes the program's
    variables of the model (of its int8 variables under ``use_int8``), and
    under ``--mesh-devices`` the mesh slots' devices, which the stream
    stages each granule onto."""

    infer: Callable
    depth: int
    batch_granules: int
    infer_is_batched: bool
    use_int8: bool
    calib_tile: int
    variables_of: Callable = lambda variables: variables  # noqa: E731
    devices: Optional[List[torch.device]] = None


def _build_serving(args, unet_cfg, threshold: float, device) -> _Serving:
    """The multi-granule inference program of the chosen forward, at the
    ``--tuned`` geometry when that is given; with ``--exported`` the
    artifact's program (:func:`_exported_serving`)."""
    from plumekit_torch.infer import make_multi_granule_infer

    if args.exported:
        return _exported_serving(args, unet_cfg, device)
    if args.tuned:
        _apply_tuned(args, unet_cfg)
    if args.fused and args.int8:
        raise _CliError("--fused and --int8 are mutually exclusive forward "
                        "paths")
    if args.fused:
        if unet_cfg.arch != "unet":
            raise _CliError("--fused supports the unet architecture only; "
                            f"checkpoint is {unet_cfg.arch}")
        from plumekit_torch.models.fused_forward import make_fused_apply

        try:
            apply_fn = make_fused_apply(unet_cfg)
        except ValueError as e:
            raise _CliError(f"--fused: {e}")
    elif args.int8:
        # the int8 forward reads the quantized variables, not the module; a
        # use_mega checkpoint takes it too, as in the JAX CLI
        from plumekit_torch.models.quantized_forward import (
            make_quantized_apply)

        try:
            apply_fn = make_quantized_apply(unet_cfg)
        except ValueError as e:
            raise _CliError(f"--int8: {e}")
    else:
        apply_fn = _module_forward
    if args.tta:
        # the 8 D4 views in one forward at 8x the batch, around any forward
        from plumekit_torch.infer.tta import make_tta_apply

        apply_fn = make_tta_apply(apply_fn)
    icfg = InferConfig(tile_size=args.tile, overlap=args.overlap,
                       batch_tiles=args.batch_tiles, threshold=threshold)
    if args.mesh_devices:
        return _mesh_serving(args, unet_cfg, apply_fn, icfg, device)
    return _Serving(make_multi_granule_infer(apply_fn, icfg,
                                             channels=unet_cfg.in_channels),
                    unet_cfg.depth, args.batch_granules, False, args.int8,
                    args.tile)


def _mesh_serving(args, unet_cfg, apply_fn, icfg, device) -> _Serving:
    """``--mesh-devices D``, with the JAX CLI's refusals: each group of
    D·``--batch-granules`` granules split over D devices
    (``infer.sliding.make_batch_infer_sharded``), every device with its own
    replica of the model (or of the int8 variables) built from the
    checkpoint's. On the card the D devices are D distinct cards, and -1
    means every visible one; on the CPU they are D replicas of the CPU (the
    rehearsal), and -1 means one device."""
    from plumekit_torch.config.train import MeshConfig
    from plumekit_torch.infer import make_batch_infer_sharded
    from plumekit_torch.parallel.mesh import make_mesh, visible_devices

    if args.fused:
        raise _CliError("--fused and --mesh-devices are not supported "
                        "together (the fused Pallas forward is a "
                        "single-chip path)")
    cards = visible_devices() if device.type == "cuda" else None
    mesh_n = args.mesh_devices
    if mesh_n == -1:
        mesh_n = len(cards) if cards is not None else 1
    if mesh_n < 2:
        raise _CliError(
            f"--mesh-devices needs at least 2 devices (got {mesh_n}); "
            "omit the flag for single-device serving")
    if cards is not None and len(cards) < mesh_n:
        raise _CliError(
            f"--mesh-devices {mesh_n} requested but only {len(cards)} "
            f"device(s) visible (gpu)")
    mesh = make_mesh(MeshConfig(data=mesh_n),
                     cards if cards is not None else [device] * mesh_n)
    infer = make_batch_infer_sharded(apply_fn, mesh, icfg,
                                     channels=unet_cfg.in_channels)
    group = mesh_n * max(1, args.batch_granules)
    logger.info("serving on a %d-device mesh (%s), %d granules per "
                "dispatched program (%d per device)", mesh_n,
                "gpu" if cards is not None else "cpu", group,
                group // mesh_n)

    def replicas(variables):
        if args.int8:
            from plumekit_torch.models.quantized_forward import qvars_to

            return [qvars_to(variables, d) for d in infer.devices]
        from plumekit_torch.models import replicate_model

        return replicate_model(variables, infer.devices)

    return _Serving(infer, unet_cfg.depth, group, True, args.int8, args.tile,
                    replicas, infer.devices)


def _exported_serving(args, unet_cfg, device) -> _Serving:
    """An ``export_model`` artifact: its program for ``device``, its
    geometry and forward. An int8 artifact calibrates on its recorded tile
    size, so that serving it does not depend on ``--tile``. ``--threshold``
    still applies to the written masks; only the program's own mask output
    carries the export-time threshold."""
    from plumekit_torch.infer.export import load_exported, serving_tree

    try:
        infer, meta = load_exported(args.exported, device)
    except ValueError as e:
        raise _CliError(str(e))
    batch_granules = int(meta["granules"])
    logger.info("serving exported program %s (granule %s, G=%d)",
                args.exported, tuple(meta["granule_hw"]), batch_granules)
    use_int8 = meta.get("forward", "flax") == "int8"
    if args.int8 and not use_int8:
        raise _CliError(
            f"--int8 passed but {args.exported} was exported with the fp "
            f"forward; re-export with export_model --int8")
    if batch_granules == 1:
        # a one-granule program takes an (H, W, C) granule; the stream
        # hands every program a (G, H, W, C) group
        single = infer

        def infer(variables, images):
            probs, masks = single(variables, images[0])
            return probs[None], masks[None]

    route = meta["route"]
    return _Serving(
        infer, int(meta["depth"]), batch_granules, batch_granules > 1,
        use_int8, int(meta["tile_size"]) if use_int8 else args.tile,
        lambda variables: serving_tree(route, unet_cfg, variables,
                                       device)[0])


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


def _int8_quantize_from_paths(granule_paths, tile, unet_cfg, model,
                              known_null=None, on_decode_error=None):
    """Calibrate the int8 forward on the first granule with signal among
    the first ``INT8_CALIBRATION_CANDIDATES`` of ``granule_paths`` not in
    ``known_null``, on a 3×3 grid of tiles (the fp32 replay keeps
    full-resolution planes of every level, so not on the whole granule), as
    ``plumekit predict_model --int8`` and ``serve --int8`` do.

    Returns ``(qvars or None, predecoded)``: every decode made here is
    handed back for the stream, so that no granule is decoded twice; None
    when none of the candidates has signal. An all-null granule (every
    activation scale would collapse to about 0 and clip all later signal)
    is skipped with a warning and added to ``known_null`` (a set, updated in
    place when given), so that a long-running caller does not decode it
    again every cycle; it is still served once calibration succeeds. A
    candidate whose decode raises is fatal unless ``on_decode_error(path)``
    is given, which then takes the granule (``serve`` quarantines it) and
    the search goes on."""
    from plumekit_torch.infer import streaming
    from plumekit_torch.models.quantized_forward import quantize_unet

    candidates = [p for p in granule_paths
                  if known_null is None
                  or os.path.basename(p) not in known_null]
    predecoded, chosen, calib = {}, None, None
    for path in candidates[:INT8_CALIBRATION_CANDIDATES]:
        try:
            cand = streaming.decode_granule_channels(path, unet_cfg.depth)
        except Exception:
            if on_decode_error is None:
                raise
            on_decode_error(path)
            continue
        predecoded[path] = cand
        if float(np.abs(cand[1]).max()) > 1e-3:
            chosen, calib = path, cand[1]
            break
        logger.warning("int8: %s is all-null — not usable for calibration, "
                       "trying the next granule", os.path.basename(path))
        if known_null is not None:
            known_null.add(os.path.basename(path))
    if chosen is None:
        return None, predecoded
    h, w = calib.shape[:2]
    div = 2 ** unet_cfg.depth
    t = max(div, min(tile - tile % div, h, w))
    ys = sorted({int(v) for v in np.linspace(0, h - t, 3)})
    xs = sorted({int(v) for v in np.linspace(0, w - t, 3)})
    tiles = np.stack([calib[y:y + t, x:x + t] for y in ys for x in xs])
    qvars = quantize_unet(model, unet_cfg, tiles)
    logger.info("int8: calibrated on %d %d² tiles of %s, serving the s8 "
                "forward", len(tiles), t, os.path.basename(chosen))
    return qvars, predecoded


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


def _write_prediction(out_dir, name, probs, plot=False, granule_path=None,
                      threshold=0.5):
    """Atomically write ``<name>_pred.npz`` with the mask thresholded here,
    from the fp32 probs, and with ``plot`` the quicklook
    ``<name>_pred.png`` of the granule's first layer (nulls as 0)."""
    out = os.path.join(out_dir, name + "_pred.npz")
    tmp = os.path.join(out_dir, f".{name}_pred.tmp{os.getpid()}.npz")
    mask = probs > threshold
    np.savez_compressed(tmp, probs=probs, mask=mask,
                        threshold=np.float32(threshold))
    os.replace(tmp, out)
    logger.info("%s: %.1f%% plume pixels (threshold %.2f)", out,
                100.0 * float(mask.mean()), threshold)
    if plot and granule_path is not None:
        from plumekit_torch.io.granule import NULL_VALUE, load_granule
        from plumekit_torch.viz import plot_prediction

        aod = load_granule(granule_path).first_layer().copy()
        aod[aod == NULL_VALUE] = 0.0
        plot_prediction(aod, probs, os.path.join(out_dir, name + "_pred.png"))
    return out


def cmd_predict_model(args) -> int:
    """Sliding-window inference over granules → plume-probability NPZs."""
    from plumekit_torch.infer.streaming import stream_inference
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS

    if _refused(args):
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
        serving = _build_serving(args, unet_cfg, threshold, device)
    except _CliError as e:
        logger.error("%s", e)
        return 1

    out_dir = paths.ensure("predictions_dir")
    maiac_dir = paths.ensure("maiac_dir")
    _sweep_stale_tmps(out_dir)
    granule_paths = [os.path.join(maiac_dir, f)
                     for f in sorted(os.listdir(maiac_dir))
                     if f.endswith(GRANULE_EXTENSIONS)]
    variables, predecoded = model, None
    if serving.use_int8 and granule_paths:
        variables, predecoded = _int8_quantize_from_paths(
            granule_paths, serving.calib_tile, unet_cfg, model)
        if variables is None:
            logger.error("int8: no granule with signal among the first %d "
                         "of %d — refusing to serve with degenerate "
                         "calibration scales",
                         min(INT8_CALIBRATION_CANDIDATES, len(granule_paths)),
                         len(granule_paths))
            return 1
    # granule i+1 decodes (on a pool) and uploads (on a stager thread)
    # while granule i computes and is written here, in order
    variables = serving.variables_of(variables)
    with torch.inference_mode():
        for name, probs in stream_inference(
                granule_paths, serving.infer, variables, serving.depth,
                device, quantize=args.quantize,
                batch_granules=serving.batch_granules, predecoded=predecoded,
                quantize_output=args.quantize_output,
                infer_is_batched=serving.infer_is_batched,
                devices=serving.devices):
            gp = next((p for p in granule_paths
                       if os.path.splitext(os.path.basename(p))[0] == name),
                      None) if args.plot else None
            _write_prediction(out_dir, name, probs, plot=args.plot,
                              granule_path=gp, threshold=threshold)
    return 0


def cmd_tune(args) -> int:
    """Time candidate serving geometries on the device and write the ranked
    table (``plumekit tune``); ``predict_model --tuned`` and ``serve
    --tuned`` then serve its winner. The checkpoint's own forward is timed
    (cuDNN; K6 under ``use_pallas``; K7 under ``use_mega``), or with
    ``--int8`` the int8 forward (Q1, Q2), on untrained weights when there
    is no checkpoint: the rate does not depend on the weights' values."""
    from plumekit_torch.infer.tune import (DEFAULT_CANDIDATES, TUNED_BASENAME,
                                           parse_candidates, save_tuned,
                                           tune_geometry)

    try:
        granules = [int(x) for x in
                    args.granules_per_program.split(",") if x.strip()]
        geoms = parse_candidates(args.candidates or DEFAULT_CANDIDATES,
                                 granules)
    except ValueError as e:
        logger.error("tune: %s", e)
        return 1
    try:
        device = resolve_device(args.device)
        unet_cfg, model = _restore_model(args, device)
    except (RuntimeError, _CliError) as e:
        logger.error("%s", e)
        return 1
    apply_fn, variables = _module_forward, model
    if args.int8:
        from plumekit_torch.models.quantized_forward import (
            make_quantized_apply, quantize_unet)

        try:
            apply_fn = make_quantized_apply(unet_cfg)
        except ValueError as e:
            logger.error("--int8: %s", e)
            return 1
        # random calibration tiles: the scales' values do not change the
        # timed program's work; serving calibrates on a granule
        calib = np.random.default_rng(1).random(
            (4, args.tile_calib, args.tile_calib, unet_cfg.in_channels),
            np.float32)
        variables = quantize_unet(model, unet_cfg, calib)
    try:
        payload = tune_geometry(
            apply_fn, variables, unet_cfg.in_channels, args.granule, geoms,
            repeats=args.repeats, device=device,
            progress=lambda msg: logger.info("tune: %s", msg))
    except RuntimeError:
        # every candidate refused, or a kernel or CUDA fault: no ranking
        logger.exception("tune: no geometry ranked")
        return 1
    payload["int8"] = bool(args.int8)
    payload["arch"] = unet_cfg.arch
    out = args.out or os.path.join(args.root, PathsConfig().model_dir,
                                   TUNED_BASENAME)
    save_tuned(out, payload)
    logger.info("tuned geometry written to %s", out)
    print(json.dumps({"best": payload["best"],
                      "best_blended": payload["best_blended"], "out": out}))
    return 0


class _DeviceFault(Exception):
    """A kernel's launch error or a CUDA error other than out-of-memory
    while ``serve`` ran a granule: no granule's fault."""


def cmd_serve(args) -> int:
    """Continuous serving (``plumekit serve``, :mod:`plumekit_torch.infer.
    serve`): the program is built once; each cycle streams the granules not
    yet in ``served_granules.txt`` or ``failed_granules.txt``, writes each
    prediction atomically and then marks it. A granule whose own decode or
    forward fails is quarantined in ``failed_granules.txt``; a kernel's
    launch error or a CUDA error other than out-of-memory is no granule's
    fault, so serve logs it and exits 1 instead. SIGINT and SIGTERM stop
    after the current granule."""
    import signal
    import threading

    from plumekit_torch.infer.serve import UnionLog, serve_loop
    from plumekit_torch.infer.streaming import (decode_granule_channels,
                                                stream_inference)
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS
    from plumekit_torch.train.checkpoint import WorkLog

    if _refused(args):
        return 1
    paths = PathsConfig(root=args.root)
    try:
        device = resolve_device(args.device)
        unet_cfg, model = _restore_model(args, device)
        serving = _build_serving(args, unet_cfg, _resolve_threshold(args),
                                 device)
    except (RuntimeError, _CliError) as e:
        logger.error("%s", e)
        return 1

    out_dir = paths.ensure("predictions_dir")
    maiac_dir = paths.ensure("maiac_dir")
    _sweep_stale_tmps(out_dir)
    worklog = WorkLog(os.path.join(out_dir, "served_granules.txt"))
    # a granule whose decode or forward fails on its own (a corrupt upload
    # that finished) is quarantined so that it cannot crash-loop the
    # daemon; delete its line to retry it
    failed_log = WorkLog(os.path.join(out_dir, "failed_granules.txt"))
    stop = threading.Event()

    def on_signal(signum, _frame):
        logger.info("serve: received signal %d — finishing the current "
                    "granule, then exiting", signum)
        stop.set()

    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[sig] = signal.signal(sig, on_signal)
        except ValueError:
            pass  # not the main thread

    # int8: calibrated lazily on the first granule with signal; until then
    # every cycle defers its batch. known_null keeps all-null candidates
    # from being decoded again every poll
    state = {"variables": None, "known_null": set(), "warned": False,
             "failures": 0, "fault": False}
    if not serving.use_int8:
        state["variables"] = serving.variables_of(model)

    def quarantine(gpath):
        failed_log.mark(os.path.basename(gpath))
        state["failures"] += 1
        logger.exception("serve: %s failed — quarantined in "
                         "failed_granules.txt (delete its line to retry)",
                         os.path.basename(gpath))

    def serve_paths(paths_list, predecoded, served_acc):
        """Stream ``paths_list``, writing and marking each granule as it
        completes into ``served_acc``, so that the granules served before a
        failure still count."""
        path_iter = iter(paths_list)
        # per batch: a recalibrated threshold.json applies from the next scan
        threshold = _resolve_threshold(args)
        with torch.inference_mode():
            for name, probs in stream_inference(
                    paths_list, serving.infer, state["variables"],
                    serving.depth, device, quantize=args.quantize,
                    batch_granules=serving.batch_granules,
                    predecoded=predecoded,
                    quantize_output=args.quantize_output,
                    infer_is_batched=serving.infer_is_batched,
                    devices=serving.devices):
                gpath = next(path_iter)    # the stream keeps the order
                stem = os.path.splitext(os.path.basename(gpath))[0]
                if stem != name:
                    logger.warning("serve: granule name %r differs from file "
                                   "stem %r — worklog keys by filename",
                                   name, stem)
                _write_prediction(out_dir, name, probs, plot=args.plot,
                                  granule_path=gpath, threshold=threshold)
                worklog.mark(os.path.basename(gpath))
                served_acc.append(os.path.basename(gpath))
                if stop.is_set():
                    break  # the rest stays pending for the restart

    def serve_alone(gpath, served_acc):
        """One granule after a failed batched pass: quarantined when its own
        decode or forward fails (a refused shape, out of memory);
        :class:`_DeviceFault` for a RuntimeError of the forward."""
        try:
            item = decode_granule_channels(gpath, serving.depth)
        except Exception:
            quarantine(gpath)
            return
        try:
            serve_paths([gpath], {gpath: item}, served_acc)
        except torch.OutOfMemoryError:
            quarantine(gpath)
        except RuntimeError as e:
            raise _DeviceFault(f"{os.path.basename(gpath)}: {e}") from e
        except Exception:
            quarantine(gpath)

    def serve_batch(pending, served_acc):
        predecoded = None
        if state["variables"] is None:
            try:
                qvars, predecoded = _int8_quantize_from_paths(
                    pending, serving.calib_tile, unet_cfg, model,
                    known_null=state["known_null"],
                    on_decode_error=quarantine)
                if qvars is not None:
                    qvars = serving.variables_of(qvars)
            except torch.OutOfMemoryError:
                raise
            except RuntimeError as e:
                raise _DeviceFault(f"int8 calibration: {e}") from e
            if qvars is None:
                if not state["warned"]:
                    logger.warning(
                        "int8: no granule with signal yet among %d pending "
                        "— deferring until a calibratable granule arrives",
                        len(pending))
                    state["warned"] = True
                return
            state["variables"] = qvars
        try:
            serve_paths(pending, predecoded, served_acc)
            return
        except Exception:
            logger.exception("serve: batched pass failed — isolating per "
                             "granule to locate the poison granule")
        # a granule that fails alone is the culprit; what is marked already
        # (served or quarantined) is skipped
        done = set(served_acc) | failed_log.items()
        for gpath in pending:
            if os.path.basename(gpath) in done or stop.is_set():
                continue
            serve_alone(gpath, served_acc)

    def process_batch(pending):
        served = []
        try:
            serve_batch(pending, served)
        except _DeviceFault:
            logger.exception("serve: a kernel or CUDA fault is no granule's "
                             "fault — nothing quarantined, stopping")
            state["fault"] = True
            stop.set()
        return len(served)

    try:
        stats = serve_loop(
            maiac_dir, UnionLog(worklog, failed_log), process_batch,
            GRANULE_EXTENSIONS, poll_s=args.poll, once=args.once,
            idle_exit=args.idle_exit, max_cycles=args.max_cycles,
            settle_s=args.settle, stop_event=stop)
    finally:
        for sig, handler in previous.items():
            if handler is not None:
                signal.signal(sig, handler)
    logger.info("serve: exit (%s) after %d cycle(s), %d granule(s) served, "
                "%d quarantined", stats.stopped_by, stats.cycles,
                stats.served, state["failures"])
    if state["fault"]:
        return 1
    if args.once and state["failures"]:
        return 1  # batch semantics: a --once invocation reports failures
    return 0


def cmd_make_dataset(args) -> int:
    """Write synthetic granules and a VIIRS-like fire CSV into the
    reference's directory layout; ``--viirs-swaths N`` also writes N SDR
    swaths (``raw/viirs/sdr``) and ``--viirs-aod-pairs N`` N IVAOT/GMTCO
    h5 pairs (``raw/viirs/{aod,geo}``) with their fires in
    ``raw/fires/fires_viirs_aod.csv``."""
    from plumekit_torch.io.granule import save_granule
    from plumekit_torch.io.synthetic import (SyntheticSceneConfig,
                                             make_scene, write_fire_csv)

    if args.viirs_aod_pairs and not _h5py_present():
        return 1
    paths = PathsConfig(root=args.root)
    maiac_dir = paths.ensure("maiac_dir")
    fires_dir = paths.ensure("fires_dir")
    tables = []
    for i in range(args.n_granules):
        scene = make_scene(SyntheticSceneConfig(
            size=args.size, n_plumes=args.plumes, seed=args.seed + i,
            background_level=0.2, background_noise=0.05,
            plume_amplitude=(0.6, 0.8), plume_sigma_major=(9.0, 14.0),
            plume_sigma_minor=(1.8, 2.6), fires_per_plume=(7, 9),
            extra_fires=4, null_blobs=1))
        out = os.path.join(maiac_dir, scene.granule.name + ".npz")
        save_granule(out, scene.granule)
        tables.append(scene.fires)
        logger.info("wrote %s (%d fires)", out, len(scene.fires["frp"]))
    fire_csv = os.path.join(fires_dir, "fires.csv")
    write_fire_csv(fire_csv, _concat_fires(tables))
    logger.info("wrote %s (%d rows)", fire_csv,
                sum(len(t["frp"]) for t in tables))

    if args.viirs_swaths:
        from plumekit_torch.io.viirs import make_synthetic_swath, save_swath

        sdr_dir = paths.ensure("viirs_sdr_dir")
        for i in range(args.viirs_swaths):
            swath = make_synthetic_swath(
                seed=args.seed + i, name=f"viirs_sdr_{args.seed + i:04d}")
            out = os.path.join(sdr_dir, swath.name + ".npz")
            save_swath(out, swath)
            logger.info("wrote %s %s", out, swath.shape)

    if args.viirs_aod_pairs:
        from plumekit_torch.io.viirs_aod import (make_synthetic_ivaot_scene,
                                                 write_synthetic_pair)

        aod_dir = paths.ensure("viirs_aod_dir")
        geo_dir = paths.ensure("viirs_geo_dir")
        pair_fires = []
        for i in range(args.viirs_aod_pairs):
            stamp, aod, vlat, vlon, vfires, _ = make_synthetic_ivaot_scene(
                seed=args.seed + i)
            ap, _ = write_synthetic_pair(aod_dir, geo_dir, stamp, aod,
                                         vlat, vlon)
            pair_fires.append(vfires)
            logger.info("wrote %s + geo", os.path.basename(ap))
        vcsv = os.path.join(fires_dir, "fires_viirs_aod.csv")
        write_fire_csv(vcsv, _concat_fires(pair_fires))
        logger.info("wrote %s (%d rows)", vcsv,
                    sum(len(t["frp"]) for t in pair_fires))
    return 0


def _concat_fires(tables):
    """The CSV columns of several fire tables, row after row."""
    return {k: np.concatenate([t[k] for t in tables])
            for k in ("latitude", "longitude", "frp", "acq_date")}


def _h5py_present() -> bool:
    """True if h5py imports; else logs the named refusal (the machine with
    the card has no h5py: its VIIRS path is the arrays entry,
    ``io/viirs_aod.identify_viirs_arrays``)."""
    from plumekit_torch.io.granule import _h5py

    try:
        _h5py()
    except ImportError as e:
        logger.error("%s", e)
        return False
    return True


def cmd_resample_viirs(args) -> int:
    """Reproject every SDR swath under ``raw/viirs/sdr`` onto its modal UTM
    zone: ``raw/reprojected_viirs/h5/<base>.h5`` and, with
    ``--quicklooks``, the blue and true-colour PNGs; an existing product is
    skipped. Host work only (the plan and its gathers)."""
    from plumekit_torch.io.viirs import (load_swath, reproject_swath,
                                         write_quicklooks,
                                         write_reprojected_h5)
    from plumekit_torch.viz.plots import _plt

    if not _h5py_present():
        return 1
    if args.quicklooks:
        try:
            _plt("--quicklooks")
        except ImportError as e:
            logger.error("%s", e)
            return 1
    paths = PathsConfig(root=args.root)
    sdr_dir = paths.ensure("viirs_sdr_dir")
    h5_dir = paths.ensure("viirs_sdr_reproj_h5_dir")
    n_done = 0
    for fname in sorted(os.listdir(sdr_dir)):
        if not fname.endswith(".npz"):
            continue
        base = os.path.splitext(fname)[0]
        out_h5 = os.path.join(h5_dir, base + ".h5")
        if os.path.exists(out_h5):
            logger.info("%s already reprojected, continuing...", base)
            continue
        swath = load_swath(os.path.join(sdr_dir, fname))
        resampler, rasters = reproject_swath(
            swath, pixel_size_m=args.pixel_size,
            radius_of_influence_m=args.radius)
        write_reprojected_h5(out_h5, resampler, rasters)
        if args.quicklooks:
            write_quicklooks(
                base, rasters,
                blue_dir=paths.ensure("viirs_sdr_reproj_blue_dir"),
                tcc_dir=paths.ensure("viirs_sdr_reproj_tcc_dir"))
        n_done += 1
        logger.info("%s → %s (zone %d%s, %dx%d)", fname, out_h5,
                    resampler.zone, "S" if resampler.south else "N",
                    resampler.y_size, resampler.x_size)
    logger.info("reprojected %d swaths", n_done)
    return 0


def cmd_identify_viirs(args) -> int:
    """The reference notebook's workflow over every IVAOT/GMTCO pair under
    ``raw/viirs/{aod,geo}``: resample to the UTM grid, the basic detector
    on ``--device``, and ``raw/viirs/masks/<base>_mask.npz`` then
    ``<base>_plumes.csv`` (the resume key) per granule."""
    from plumekit_torch.io.fires import load_fire_csv
    from plumekit_torch.io.tables import Table
    from plumekit_torch.io.viirs_aod import identify_viirs_aod, pair_granules

    if not _h5py_present():
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    paths = PathsConfig(root=args.root)
    aod_dir = paths.ensure("viirs_aod_dir")
    geo_dir = paths.ensure("viirs_geo_dir")
    masks_dir = paths.ensure("viirs_masks_dir")
    fire_csv = args.fires or os.path.join(paths.ensure("fires_dir"),
                                          "fires_viirs_aod.csv")
    if not os.path.exists(fire_csv):
        logger.error("no fire table at %s — run 'plumekit-torch make_dataset "
                     "--viirs-aod-pairs' or point --fires at a VIIRS fire "
                     "CSV", fire_csv)
        return 1
    fires = load_fire_csv(fire_csv)

    pairs = pair_granules(aod_dir, geo_dir)
    if not pairs:
        logger.warning("no IVAOT/GMTCO pairs under %s / %s", aod_dir,
                       geo_dir)
        return 1
    for pair in pairs:
        base = os.path.splitext(os.path.basename(pair["aod"]))[0]
        out_csv = os.path.join(masks_dir, base + "_plumes.csv")
        if os.path.exists(out_csv):
            logger.info("%s already identified, continuing...", base)
            continue
        plume_dict, plume_image, aod_r, _ = identify_viirs_aod(
            pair["aod"], pair["geo"], fires, pixel_size_m=args.pixel_size,
            device=device)
        # the mask first, the bbox CSV last: resume keys on the CSV
        np.savez_compressed(os.path.join(masks_dir, base + "_mask.npz"),
                            plume_image=plume_image,
                            aod=np.nan_to_num(aod_r, nan=-999.0))
        Table(("plume_id", "min_r", "min_c", "max_r", "max_c"),
              [(pid, b["min_r"], b["min_c"], b["max_r"], b["max_c"])
               for pid, b in plume_dict.items()]).to_csv(out_csv)
        logger.info("%s: %d plume(s) → %s", base, len(plume_dict), out_csv)
    return 0


def cmd_verify_real_granule(args) -> int:
    """One granule file through the real-data contract register
    (``io/verify.py``): prints the JSON summary as its last line and exits
    0 only when every check that ran passed."""
    from plumekit_torch.io.verify import verify_granule

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    res = verify_granule(args.granule, fires_csv=args.fires,
                         detector=args.detector,
                         run_identify=not args.no_identify, device=device)
    for c in res.checks:
        logger.info("%-18s %-4s %s", c.name, c.status.upper(), c.detail)
    print(json.dumps(res.summary()))
    return 0 if res.ok else 1


def cmd_train_model(args) -> int:
    """Train the U-Net or UNet++ (``plumekit_torch.train.loop.train``) on
    the device of ``--device``."""
    from plumekit_torch.config.train import DataConfig, TrainConfig
    from plumekit_torch.train.loop import train

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    devices = None
    if args.data_parallel > 1:
        from plumekit_torch.parallel.launch import data_parallel_devices

        try:
            devices = data_parallel_devices(args.data_parallel, device)
        except ValueError as e:
            logger.error("%s", e)
            return 1
    curated_dir = None
    if args.curated:
        curated_dir = PathsConfig(root=args.root).resolve("model_data_dir")
    distill_calibrate = None
    if args.distill_calibrate == "auto":
        path = os.path.join(args.root, PathsConfig().model_dir,
                            THRESHOLD_BASENAME)
        try:
            with open(path) as f:
                distill_calibrate = float(json.load(f)["threshold"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            logger.error(
                "--distill-calibrate given without a value but %s is "
                "unreadable (%s); run evaluate_model --sweep-threshold "
                "--write-threshold first or pass the value", path, e)
            return 1
        logger.info("distill calibration threshold %.2f from %s",
                    distill_calibrate, path)
    elif args.distill_calibrate is not None:
        distill_calibrate = float(args.distill_calibrate)
    kwargs = dict(
        unet_cfg=UNetConfig(arch=args.arch,
                            deep_supervision=args.deep_supervision),
        train_cfg=TrainConfig(
            total_steps=args.steps, batch_size=args.batch_size,
            tile_size=args.tile, checkpoint_dir=os.path.join(
                args.root, PathsConfig().model_dir, "checkpoints"),
            steps_per_dispatch=args.steps_per_dispatch,
            device_data=args.device_data,
            quantize_transfer=args.quantize_transfer,
            distill_from=args.distill_from, distill_alpha=args.distill_alpha,
            distill_temp=args.distill_temp,
            distill_prune_level=args.distill_prune_level,
            distill_tta=args.distill_tta,
            distill_calibrate=distill_calibrate),
        data_cfg=DataConfig(granule_size=args.granule_size),
        weak_labels=args.weak_labels, curated_dir=curated_dir)
    if devices is None:
        history = train(device=device, **kwargs)
    else:
        from plumekit_torch.config.train import MeshConfig
        from plumekit_torch.parallel.launch import launch

        logger.info("training on %d ranks (%s)", len(devices),
                    ", ".join(str(d) for d in devices))
        history = launch(train_rank, devices, args=(
            dict(kwargs, mesh_cfg=MeshConfig(data=len(devices))),))
    logger.info("final eval IoU %.3f", history["eval_iou"][-1])
    return 0


def train_rank(rank: int, device, kwargs: dict) -> dict:
    """One rank of ``train_model --data-parallel``: the training loop on
    ``device`` as a rank of the launched process group; rank 0 alone
    logs."""
    from plumekit_torch.train.loop import train

    if rank:
        get_logger("plumekit_torch").setLevel("WARNING")
    return train(device=device, **kwargs)


def cmd_build_features(args) -> int:
    """Identify plumes in every granule with the chosen detector, one CSV
    set per granule, resumable through the detector's work log (the
    reference's ``plume_identifier_rg.main()`` loop)."""
    from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                                GaussianIdentifyConfig,
                                                RGIdentifyConfig)
    from plumekit_torch.identify import gaussian as gaussian_mod
    from plumekit_torch.identify import rg as rg_mod
    from plumekit_torch.identify.api import identify as api_identify
    from plumekit_torch.io.dates import granule_date
    from plumekit_torch.io.fires import load_fire_csv, n_fires
    from plumekit_torch.io import prefetch
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS, load_granule
    from plumekit_torch.train.checkpoint import WorkLog
    from plumekit_torch.viz import plot_identify_bboxes, plot_identify_hulls

    if args.batch_scenes < 1:
        logger.error("--batch-scenes must be >= 1, got %d", args.batch_scenes)
        return 1
    if args.batch_scenes > 1 and args.detector != "rg":
        logger.error("--batch-scenes applies to the rg detector only")
        return 1
    if _plot_refused(args):
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
    todo = []
    for fname in sorted(os.listdir(maiac_dir)):
        if not fname.endswith(GRANULE_EXTENSIONS):
            continue
        if fname in done:
            logger.info("%s already processed, continuing...", fname)
            continue
        todo.append(fname)

    def decode(fname):
        # MAIAC names carry the acquisition date; synthetic granules fall
        # back to the fire table's first date
        return (fname, load_granule(os.path.join(maiac_dir, fname)),
                granule_date(fname, default=default_date))

    # granule i+1 decodes on a pool while granule i identifies; depth
    # bounds the granules held in host memory
    stream = prefetch.decode_pool(todo, decode,
                                  workers=prefetch.default_decode_workers(),
                                  depth=max(2, args.batch_scenes + 1))

    n_done = 0

    def finish(fname, hull_table):
        # the hull CSV last: the log and the CSV mark a granule as done
        nonlocal n_done
        base = os.path.splitext(fname)[0]
        hull_table.to_csv(os.path.join(hull_dir, base + "_extent.csv"))
        log.mark(fname)
        n_done += 1
        logger.info("%s: %d plumes", base, len(set(hull_table.column("id"))))

    def plot_path(fname):
        return os.path.join(paths.ensure("plot_dir"),
                            os.path.splitext(fname)[0] + "_plot.png")

    def write_rg(fname, granule, aod_table, hull_table, out):
        base = os.path.splitext(fname)[0]
        aod_table.to_csv(os.path.join(aod_dir, base + "_aod.csv"))
        if not args.no_masks:
            masks = rg_mod.plume_masks(out)
            if masks:
                np.savez_compressed(
                    os.path.join(paths.ensure("plume_mask_dir"),
                                 base + "_masks.npz"),
                    **{str(pid): m for pid, m in masks.items()})
        if args.plot and len(aod_table):
            plot_identify_bboxes(granule.first_layer(), aod_table,
                                 plot_path(fname))
        finish(fname, hull_table)

    if args.batch_scenes > 1:
        # groups of same-shape scenes; a change of shape flushes the group
        buf = []

        def flush():
            if not buf:
                return
            results = rg_mod.identify_batch(
                [(g.first_layer(), g.lat, g.lon, d) for _, g, d in buf],
                fires, RGIdentifyConfig(), device=device)
            for (fname, g, _d), result in zip(buf, results):
                write_rg(fname, g, *result)
            buf.clear()

        for fname, granule, date in stream:
            if buf and granule.shape != buf[0][1].shape:
                flush()
            buf.append((fname, granule, date))
            if len(buf) == args.batch_scenes:
                flush()
        flush()
        logger.info("processed %d granules", n_done)
        return 0

    for fname, granule, date in stream:
        if args.detector == "rg":
            write_rg(fname, granule, *rg_mod.identify(
                granule.first_layer(), granule.lat, granule.lon, date, fires,
                RGIdentifyConfig(), device=device))
        elif args.detector == "basic":
            # the api zeroes negative AOD and lays out the bbox rows
            table = api_identify(granule, fires, date, BasicIdentifyConfig(),
                                 device=device).aod_stats
            if args.plot and len(table):
                aod = granule.first_layer().copy()
                aod[aod < 0] = 0.0
                plot_identify_bboxes(aod, table, plot_path(fname))
            finish(fname, table)
        else:
            table = gaussian_mod.identify_granule(
                granule, fires, date, GaussianIdentifyConfig(), device=device)
            if args.plot and len(table):
                plot_identify_hulls(granule.first_layer(), table,
                                    plot_path(fname))
            finish(fname, table)
    logger.info("processed %d granules", n_done)
    return 0


def cmd_identify(args) -> int:
    """One granule through any detector: prints ``<n> plumes`` and, with
    ``--out``, writes the hull table if it has rows."""
    from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                                GaussianIdentifyConfig,
                                                RGIdentifyConfig)
    from plumekit_torch.identify.api import identify
    from plumekit_torch.io.dates import granule_date
    from plumekit_torch.io.fires import load_fire_csv, n_fires
    from plumekit_torch.io.granule import load_granule

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    cfg = {"rg": RGIdentifyConfig(), "gaussian": GaussianIdentifyConfig(),
           "basic": BasicIdentifyConfig()}[args.detector]
    granule = load_granule(args.granule)
    fires = load_fire_csv(args.fires)
    # the granule's file name dates the scene, as in build_features; the
    # fire table's first row is only the fallback
    date = granule_date(
        os.path.basename(args.granule),
        default=fires["date_time"][0] if n_fires(fires) else None)
    plumes = identify(granule, fires, date, cfg, device=device)
    print(f"{len(plumes)} plumes")
    if args.out and len(plumes.hulls):
        plumes.hulls.to_csv(args.out)
        logger.info("wrote %s", args.out)
    return 0


def cmd_select(args) -> int:
    """Curation of every hull table: apply a decisions CSV, or write
    review batches (``plumekit select``)."""
    from plumekit_torch.io.granule import (LAYER0_SENTINEL, find_granule,
                                           load_granule)
    from plumekit_torch.io.tables import Table, read_decisions
    from plumekit_torch.label import apply_decisions, export_review_batch

    keep_set = None
    if args.decisions:
        keep_set = read_decisions(args.decisions)
    else:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.error("select without --decisions writes PNG review "
                         "batches and needs matplotlib, which is not "
                         "installed; pass --decisions to apply decisions")
            return 1
    paths = PathsConfig(root=args.root)
    hull_dir = paths.ensure("hull_df_dir")
    maiac_dir = paths.ensure("maiac_dir")
    for fname in sorted(os.listdir(hull_dir)):
        if not fname.endswith("_extent.csv"):
            continue
        plumes = Table.read_csv(os.path.join(hull_dir, fname))
        if not {"hull_x", "hull_y"} <= set(plumes.columns):
            # the basic detector's bbox-only extent CSVs have no hulls
            logger.info("%s has no hull columns (basic detector) — "
                        "skipping curation", fname)
            continue
        if "datetime" not in plumes.columns:
            plumes = plumes.with_column("datetime", LAYER0_SENTINEL)
        base = fname.replace("_extent.csv", "")
        gpath = find_granule(maiac_dir, base)
        if gpath is None:
            logger.warning("no granule for %s", fname)
            continue
        granule = load_granule(gpath)
        if keep_set is not None:
            kept, rejected = apply_decisions(
                plumes, granule,
                lambda r: (r.plume_id, r.datetime) in keep_set)
            kept.to_csv(os.path.join(
                paths.ensure("reduced_plume_hull_dir"), fname))
            rejected.to_csv(os.path.join(
                paths.ensure("reduced_not_plume_hull_dir"), fname))
            logger.info("%s: kept %d / rejected %d plume rows", base,
                        len(kept), len(rejected))
        else:
            scores = None
            if args.rank_with_predictions is not None:
                scores = _curation_scores(args, paths, base, plumes)
            out_dir = os.path.join(args.root, "review", base)
            manifest = export_review_batch(plumes, granule, out_dir,
                                           scores=scores)
            logger.info("%s: %d plumes staged for review in %s%s", base,
                        len(manifest), out_dir,
                        " (model-ranked)" if scores is not None else "")
    return 0


def cmd_report(args) -> int:
    """Campaign summary under ``<root>/reports/`` (``plumekit report``):
    prints the path of ``report.md``. The training figure is drawn where
    matplotlib is installed."""
    from plumekit_torch.viz.report import build_report

    print(build_report(args.root, out_dir=args.out))
    return 0


def _curation_scores(args, paths, base, plumes):
    """Per-plume model support for ``select --rank-with-predictions``, or
    None with a warning (the queue stays in file order) when the granule
    has no usable prediction."""
    from plumekit_torch.label import (load_plume_masks, load_prediction,
                                      plume_support)

    pred_dir = args.rank_with_predictions or paths.resolve("predictions_dir")
    probs = load_prediction(pred_dir, base)
    if probs is None:
        logger.warning(
            "%s: no prediction in %s — review queue stays in file order "
            "(run predict_model first to rank it)", base, pred_dir)
        return None
    masks = load_plume_masks(paths.resolve("plume_mask_dir"), base)
    try:
        return plume_support(probs, plumes, masks)
    except Exception as e:
        # a stale or malformed artifact must not abort the whole export
        logger.warning("%s: scoring failed (%s: %s) — review queue stays "
                       "in file order", base, type(e).__name__, e)
        return None


def cmd_prepare_model_data(args) -> int:
    """Kept hulls (or their device masks) → model-ready samples under
    ``model_data_dir``; exit 1 when none is written."""
    from plumekit_torch.train.curated import build_model_data

    paths = PathsConfig(root=args.root)
    written = build_model_data(paths, fire_csv=args.fires,
                               use_masks=not args.hulls_only,
                               uncurated=args.uncurated)
    logger.info("wrote %d model-ready samples to %s", len(written),
                paths.resolve("model_data_dir"))
    return 0 if written else 1


def _evaluation_infer(args, unet_cfg, device):
    """``infer(model, channels (H, W, C) numpy) -> (probs, mask)`` on
    ``device``: the sliding-window inference of the checkpoint's own
    forward (K6 for ``use_pallas``, K7 for ``use_mega``), fp32 without
    TF32."""
    from plumekit_torch.infer import make_sliding_infer
    from plumekit_torch.models.quantized_forward import full_fp32

    sliding = make_sliding_infer(
        _module_forward,
        InferConfig(tile_size=args.tile, overlap=args.overlap,
                    batch_tiles=args.batch_tiles),
        channels=unet_cfg.in_channels)

    def infer(model, channels):
        with torch.inference_mode(), full_fp32():
            return sliding(model, torch.from_numpy(
                np.ascontiguousarray(channels)).to(device))

    return infer


def cmd_export_model(args) -> int:
    """Trace the serving program of the checkpoint's forward with
    ``torch.export`` into an artifact directory (``plumekit export_model``):
    served by ``--exported`` without the model code that traced it, with any
    checkpoint of the architecture. One program per platform of
    ``--platforms``, each traced on its own device; ``gpu`` needs a card."""
    from plumekit_torch.infer.export import export_sliding_infer, save_exported

    try:
        unet_cfg, model = _restore_model(args, torch.device("cpu"))
    except _CliError as e:
        logger.error("%s", e)
        return 1
    div = 2 ** unet_cfg.depth
    h = args.granule + (-args.granule) % div
    w = (args.granule_width or args.granule)
    w += (-w) % div
    if (h, w) != (args.granule, args.granule_width or args.granule):
        logger.info("granule padded to (%d, %d) for 2**depth divisibility",
                    h, w)
    icfg = InferConfig(tile_size=args.tile, overlap=args.overlap,
                       batch_tiles=args.batch_tiles,
                       threshold=_resolve_threshold(args))
    try:
        programs, meta = export_sliding_infer(
            model, unet_cfg, icfg, (h, w), granules=args.batch_granules,
            platforms=[p.strip() for p in args.platforms.split(",")
                       if p.strip()],
            forward="int8" if args.int8 else "flax", tta=args.tta)
    except ValueError as e:
        logger.error("export failed: %s", e)
        return 1
    out = args.out or os.path.join(args.root, PathsConfig().model_dir,
                                   "exported")
    save_exported(programs, meta, out)
    print(out)
    return 0


def cmd_evaluate_model(args) -> int:
    """Score the checkpoint (or saved predictions) against model-ready
    labels (``plumekit evaluate_model``): every refusal comes before the
    inference."""
    import time

    from plumekit_torch.train import evaluate as ev

    paths = PathsConfig(root=args.root)
    data_dir = args.data or paths.resolve("model_data_dir")
    out_csv = args.out or paths.resolve("evaluation_csv")
    if not 0.0 < args.match_iou <= 1.0:
        logger.error("--match-iou must be in (0, 1], got %s",
                     args.match_iou)
        return 1
    if args.min_size < 1:
        logger.error("--min-size must be >= 1, got %s", args.min_size)
        return 1
    if args.bootstrap < 0:
        logger.error("--bootstrap must be >= 0, got %s", args.bootstrap)
        return 1
    if args.objects and args.sweep_threshold:
        logger.error(
            "--objects and --sweep-threshold are exclusive: the sweep "
            "scores every candidate threshold (use a plume metric, e.g. "
            "--sweep-threshold obj_f1, to sweep at the plume level); "
            "run --objects separately at the calibrated threshold")
        return 1
    if args.bootstrap and args.sweep_threshold:
        logger.error(
            "--bootstrap and --sweep-threshold are exclusive: CIs attach "
            "to a single-threshold evaluation; sweep first, then re-run "
            "evaluate_model --bootstrap at the calibrated threshold")
        return 1
    metrics = ev.METRIC_KEYS + ev.OBJECT_METRIC_KEYS
    if args.sweep_threshold and args.sweep_threshold not in metrics:
        logger.error("--sweep-threshold: unknown metric %r (one of %s)",
                     args.sweep_threshold, ", ".join(metrics))
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        logger.error("%s", e)
        return 1
    infer = model = None
    if not args.predictions:
        try:
            unet_cfg, model = _restore_model(args, device)
        except _CliError as e:
            logger.error("%s", e)
            return 1
        infer = _evaluation_infer(args, unet_cfg, device)

    def pairs():
        if args.predictions:
            return ev.prediction_prob_pairs(args.predictions, data_dir)
        return ev.inference_prob_pairs(infer, model, data_dir)

    if args.sweep_threshold:
        if args.sweep_threshold in ev.OBJECT_METRIC_KEYS:
            # the pixel and plume optima differ: sweep in the served metric
            sweep = ev.sweep_object_thresholds(
                pairs(), match_iou=args.match_iou, min_size=args.min_size,
                device=device)
        else:
            sweep = ev.sweep_thresholds(pairs())
        sweep_csv = os.path.join(os.path.dirname(out_csv) or ".",
                                 "threshold_sweep.csv")
        sweep.to_csv(sweep_csv)
        t, v = ev.best_threshold(sweep, metric=args.sweep_threshold)
        payload = {"threshold": t, "metric": args.sweep_threshold,
                   "value": round(v, 4),
                   "at_default": round(ev.at_threshold(
                       sweep, args.sweep_threshold), 4),
                   "sweep_csv": sweep_csv}
        if args.write_threshold:
            tpath = os.path.join(args.root, PathsConfig().model_dir,
                                 THRESHOLD_BASENAME)
            _write_json_atomic(tpath, {
                **payload,
                "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime())})
            payload["out"] = tpath
            logger.info("calibrated threshold %.2f written to %s (serving "
                        "reads it automatically)", t, tpath)
        print(json.dumps(payload))
        return 0

    if args.objects:
        table = ev.evaluate_objects(pairs(), threshold=args.threshold,
                                    match_iou=args.match_iou,
                                    min_size=args.min_size, device=device)
        obj_csv = ev.objects_csv_path(out_csv)
        os.makedirs(os.path.dirname(obj_csv) or ".", exist_ok=True)
        table.to_csv(obj_csv)
        micro = dict(zip(table.columns, table.rows[-1]))
        payload = {
            "samples": len(table) - 1,
            "pred_plumes": int(micro["pred_plumes"]),
            "true_plumes": int(micro["true_plumes"]),
            **{k: round(float(micro[k]), 4) for k in ev.OBJECT_METRIC_KEYS},
            "out": obj_csv}
        if args.bootstrap:
            payload["ci95"] = {
                k: [round(lo, 4), round(hi, 4)] for k, (lo, hi) in
                ev.bootstrap_from_df(table, kind="object",
                                     n_boot=args.bootstrap).items()}
        print(json.dumps(payload))
        return 0

    if args.predictions:
        table = ev.evaluate_predictions(args.predictions, data_dir,
                                        threshold=args.threshold)
    else:
        table = ev.evaluate_model_data(infer, model, data_dir,
                                       threshold=args.threshold)
    payload = ev.write_report(table, out_csv)
    if args.bootstrap:
        payload["ci95"] = {
            k: [round(lo, 4), round(hi, 4)] for k, (lo, hi) in
            ev.bootstrap_from_df(table, n_boot=args.bootstrap).items()}
    print(json.dumps(payload))
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
    p.add_argument("--plot", action="store_true",
                   help="also write <name>_pred.png, the AOD | probability | "
                        "mask quicklook (needs matplotlib)")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training-quantized forward, calibrated on "
                        "the first granule with signal; every 3x3 conv "
                        "through the hand-written int8 CUDA kernel")
    p.add_argument("--tta", action="store_true",
                   help="D4 test-time augmentation: the 8 views of every "
                        "tile batch in one forward, probabilities averaged")
    p.add_argument("--quantize", action="store_true",
                   help="uint16 host-to-device payloads, dequantized on the "
                        "device")
    p.add_argument("--quantize-output", action="store_true",
                   help="uint8 probability readback (within 1/510)")
    p.add_argument("--exported", default=None,
                   help="serve an export_model artifact dir instead of the "
                        "live model; the granule geometry must match the "
                        "export")
    p.add_argument("--prune-level", type=int, default=None,
                   help="serve a deep-supervised UNet++ checkpoint pruned "
                        "at fusion level L (1..depth)")
    p.add_argument("--mesh-devices", type=int, default=0, metavar="D",
                   help="serve each granule group over a D-device mesh: "
                        "every device runs its --batch-granules granules' "
                        "tile grids with its own replica of the model; "
                        "groups are D × --batch-granules granules. D = -1 "
                        "uses every visible card (with --device cpu, D "
                        "replicas on the CPU rehearse the mesh, and -1 is "
                        "one device). Incompatible with --exported/--fused")
    p.add_argument("--tuned", nargs="?", const="auto", default=None,
                   metavar="JSON",
                   help="serve the geometry measured by `tune` (bare flag "
                        "reads <root>/models/tuned_geometry.json); "
                        "overrides --tile/--overlap/--batch-tiles/"
                        "--batch-granules")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="plumekit-torch")
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser("make_dataset", help="generate granules + fire CSV")
    d.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                   help="workspace root")
    d.add_argument("--n-granules", type=int, default=4)
    d.add_argument("--size", type=int, default=512)
    d.add_argument("--plumes", type=int, default=4)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--viirs-swaths", type=int, default=0,
                   help="also write N synthetic VIIRS SDR swaths "
                        "(raw/viirs/sdr)")
    d.add_argument("--viirs-aod-pairs", type=int, default=0,
                   help="also write N synthetic IVAOT/GMTCO h5 pairs "
                        "(raw/viirs/{aod,geo}; needs h5py)")
    d.set_defaults(fn=cmd_make_dataset)

    rv = sub.add_parser("resample_viirs",
                        help="reproject SDR swaths to UTM grids "
                             "(raw/reprojected_viirs; needs h5py)")
    rv.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    rv.add_argument("--pixel-size", type=float, default=750.0,
                    help="UTM grid pixel size in meters")
    rv.add_argument("--radius", type=float, default=10000.0,
                    help="radius of influence in meters")
    rv.add_argument("--quicklooks", action="store_true",
                    help="also write blue/tcc PNGs (needs matplotlib)")
    rv.set_defaults(fn=cmd_resample_viirs)

    iv = sub.add_parser("identify_viirs",
                        help="IVAOT/GMTCO AOD pairs → UTM resample → basic "
                             "identify → plume masks (needs h5py)")
    iv.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    iv.add_argument("--fires", default=None,
                    help="fire CSV (default raw/fires/fires_viirs_aod.csv)")
    iv.add_argument("--pixel-size", type=float, default=750.0,
                    help="UTM grid pixel size in meters")
    iv.add_argument("--device", default="cuda",
                    help="torch device of the detector (default: cuda; the "
                         "CPU runs the kernels' plain versions)")
    iv.set_defaults(fn=cmd_identify_viirs)

    t = sub.add_parser("train_model", help="train the U-Net or UNet++")
    t.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                   help="workspace root (checkpoints under "
                        "<root>/models/checkpoints)")
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--tile", type=int, default=256)
    t.add_argument("--granule-size", type=int, default=512)
    t.add_argument("--weak-labels", action="store_true",
                   help="label granules with the rg detector instead of "
                        "synthetic ground truth")
    t.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps per chunk between log, eval and "
                        "checkpoint boundaries")
    t.add_argument("--device-data", action="store_true",
                   help="keep the whole training set in the device's "
                        "memory and draw and augment tiles there")
    t.add_argument("--data-parallel", type=int, default=1,
                   help="train on N ranks, one process per card (NCCL), "
                        "the batch split over them; with --device cpu, N "
                        "ranks on the CPU (gloo)")
    t.add_argument("--curated", action="store_true",
                   help="train on the curated samples of <root>'s "
                        "model_data_dir (run prepare_model_data first)")
    t.add_argument("--quantize-transfer", action="store_true",
                   help="uint16 channels and uint8 masks across the "
                        "host-to-device hop, dequantized in the step")
    t.add_argument("--arch", choices=["unet", "unetpp"], default="unet",
                   help="architecture family")
    t.add_argument("--deep-supervision", action="store_true",
                   help="UNet++ side heads on every top-row column, "
                        "averaged (enables --prune-level serving)")
    t.add_argument("--distill-from", default=None, metavar="CKPT_DIR",
                   help="offline distillation: relabel the training "
                        "granules with this checkpoint's soft "
                        "probabilities first (the dev set keeps its "
                        "labels)")
    t.add_argument("--distill-alpha", type=float, default=1.0,
                   help="teacher blend weight: y' = a*p_teacher + (1-a)*y")
    t.add_argument("--distill-temp", type=float, default=1.0,
                   help="teacher logits divided by T before the sigmoid")
    t.add_argument("--distill-prune-level", type=int, default=None,
                   help="serve a deep-supervised UNet++ teacher pruned at "
                        "this fusion level")
    t.add_argument("--distill-tta", action="store_true",
                   help="D4-average the teacher's soft labels")
    t.add_argument("--distill-calibrate", nargs="?", const="auto",
                   default=None, metavar="THRESH",
                   help="recentre the teacher's logits so its calibrated "
                        "threshold maps to 0.5; no value reads <root>/"
                        "models/threshold.json")
    t.set_defaults(fn=cmd_train_model)

    pr = sub.add_parser("predict_model", help="sliding-window inference")
    _add_serving_args(pr)
    pr.set_defaults(fn=cmd_predict_model)

    sv = sub.add_parser("serve",
                        help="continuous serving: watch the granule dir, "
                             "predict new arrivals, resume-idempotent")
    _add_serving_args(sv)
    sv.add_argument("--poll", type=float, default=10.0,
                    help="seconds between directory scans")
    sv.add_argument("--once", action="store_true",
                    help="serve the current backlog and exit (one scan)")
    sv.add_argument("--idle-exit", type=int, default=0,
                    help="exit after N consecutive empty scans (0 = run "
                         "until signalled)")
    sv.add_argument("--max-cycles", type=int, default=0,
                    help="hard bound on scan cycles (0 = unbounded)")
    sv.add_argument("--settle", type=float, default=2.0,
                    help="skip files whose mtime is younger than this "
                         "(still-uploading guard)")
    sv.set_defaults(fn=cmd_serve)

    tn = sub.add_parser(
        "tune",
        help="time candidate serving geometries (tile/overlap/batch_tiles "
             "x granules per program) on the device and write the ranked "
             "table for predict_model/serve --tuned")
    tn.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    tn.add_argument("--device", default="cuda",
                    help="torch device to time on (default: cuda)")
    tn.add_argument("--checkpoint", default=None,
                    help="time this checkpoint's forward (default: "
                         "<root>/models/checkpoints, else untrained default "
                         "weights: the rate does not depend on their "
                         "values)")
    tn.add_argument("--int8", action="store_true",
                    help="time the int8 quantized forward")
    tn.add_argument("--prune-level", type=int, default=None,
                    help="time a deep-supervised UNet++ checkpoint pruned "
                         "at fusion level L")
    tn.add_argument("--granule", type=int, default=2048,
                    help="square granule size to tune at: the production "
                         "granule's (the optimum depends on it)")
    tn.add_argument("--granules-per-program", default="1,2,4",
                    help="comma list of G values to sweep (granules per "
                         "program)")
    tn.add_argument("--candidates", default=None,
                    help="comma list of tile/overlap[/batch_tiles] "
                         "candidates (default: the JAX package's grid)")
    tn.add_argument("--repeats", type=int, default=3,
                    help="timed calls per candidate, after one warm-up call")
    tn.add_argument("--tile-calib", type=int, default=288,
                    help="int8 calibration tile size (structure only)")
    tn.add_argument("--out", default=None,
                    help="artifact path (default <root>/models/"
                         "tuned_geometry.json)")
    tn.set_defaults(fn=cmd_tune)

    ex = sub.add_parser("export_model",
                        help="trace the serving program into an artifact "
                             "(torch.export; served by --exported without "
                             "the model code)")
    ex.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    ex.add_argument("--checkpoint", default=None)
    ex.add_argument("--granule", type=int, default=2048,
                    help="granule height (pixels); padded to 2**depth")
    ex.add_argument("--granule-width", type=int, default=None,
                    help="granule width if not square")
    ex.add_argument("--batch-granules", type=int, default=1,
                    help="granules per program (the group --exported "
                         "serves at once)")
    ex.add_argument("--tile", type=int, default=288)
    ex.add_argument("--overlap", type=int, default=32)
    ex.add_argument("--int8", action="store_true",
                    help="export the int8 post-training-quantized program; "
                         "the serving host quantizes each restored "
                         "checkpoint at load time, so the artifact stays "
                         "checkpoint-agnostic")
    ex.add_argument("--batch-tiles", type=int, default=64)
    ex.add_argument("--prune-level", type=int, default=None,
                    help="export the UNet++ grid truncated at fusion column "
                         "L (deep-supervision checkpoints; see "
                         "predict_model --prune-level)")
    ex.add_argument("--threshold", type=float, default=None,
                    help="mask threshold baked into the program (default: "
                         "the calibrated models/threshold.json if present, "
                         "else 0.5)")
    ex.add_argument("--tta", action="store_true",
                    help="bake D4 test-time augmentation into the exported "
                         "program (8 views per tile, one forward)")
    ex.add_argument("--platforms", default="gpu,cpu",
                    help="comma-separated platforms (gpu, cpu): one program "
                         "each, traced on its own device")
    ex.add_argument("--out", default=None,
                    help="artifact dir (default <root>/models/exported)")
    ex.set_defaults(fn=cmd_export_model)

    bf = sub.add_parser("build_features",
                        help="a fire-driven detector over every granule → "
                             "CSVs and (rg) plume masks")
    bf.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                    help="workspace root")
    bf.add_argument("--detector", choices=["rg", "gaussian", "basic"],
                    default="rg",
                    help="detector (default rg, the weak labeller)")
    bf.add_argument("--device", default="cuda",
                    help="torch device of the detector (default: cuda; the "
                         "CPU runs the kernels' plain versions)")
    bf.add_argument("--no-masks", action="store_true",
                    help="skip the per-plume mask npz (hull CSVs only)")
    bf.add_argument("--batch-scenes", type=int, default=1,
                    help="same-shape scenes per identify group (rg only)")
    bf.add_argument("--plot", action="store_true",
                    help="write annotated scene PNGs under raw/"
                         "plume_identification/plots (needs matplotlib)")
    bf.set_defaults(fn=cmd_build_features)

    idp = sub.add_parser("identify", help="identify plumes in one granule")
    idp.add_argument("granule", help="granule file (.npz, .h5)")
    idp.add_argument("fires", help="VIIRS fire CSV")
    idp.add_argument("--detector", choices=["rg", "gaussian", "basic"],
                     default="rg")
    idp.add_argument("--device", default="cuda",
                     help="torch device of the detector (default: cuda)")
    idp.add_argument("--out", default=None,
                     help="CSV path for the hull table")
    idp.set_defaults(fn=cmd_identify)

    vg = sub.add_parser(
        "verify_real_granule",
        help="one granule file through the real-data contract register: "
             "decode, grid, values, UTM resample, a detector smoke run; "
             "exit 0 iff every check that ran passed")
    vg.add_argument("granule", help="granule file (.hdf/.h5/.npz)")
    vg.add_argument("--fires", default=None,
                    help="fire CSV for the detector smoke run (without it "
                         "the identify check is skipped)")
    vg.add_argument("--detector", choices=["rg", "gaussian", "basic"],
                    default="rg")
    vg.add_argument("--no-identify", action="store_true",
                    help="skip the detector smoke run even with --fires")
    vg.add_argument("--device", default="cuda",
                    help="torch device of the detector (default: cuda)")
    vg.set_defaults(fn=cmd_verify_real_granule)

    s = sub.add_parser("select", help="plume curation (review/decisions)")
    s.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT", "data"),
                   help="workspace root")
    s.add_argument("--decisions", default=None,
                   help="CSV with id,datetime,keep columns")
    s.add_argument("--rank-with-predictions", nargs="?", const="",
                   default=None, metavar="DIR",
                   help="order each review manifest most-suspect-first by "
                        "the mean predicted probability over each plume "
                        "(bare flag: <root>/processed/predictions)")
    s.set_defaults(fn=cmd_select)

    pm = sub.add_parser("prepare_model_data",
                        help="curated hulls → model-ready training samples")
    pm.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT",
                                                     "data"),
                    help="workspace root")
    pm.add_argument("--fires", default=None,
                    help="fire CSV (default raw/fires/fires.csv)")
    pm.add_argument("--hulls-only", action="store_true",
                    help="rasterise convex hulls even where per-plume "
                         "device masks exist")
    pm.add_argument("--uncurated", action="store_true",
                    help="use every identified plume (hull_df_dir) instead "
                         "of the curated set")
    pm.set_defaults(fn=cmd_prepare_model_data)

    ev = sub.add_parser("evaluate_model",
                        help="score a checkpoint or saved predictions "
                             "against model-ready labels")
    ev.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT",
                                                     "data"),
                    help="workspace root")
    ev.add_argument("--device", default="cuda",
                    help="torch device of the forwards and the plume "
                         "labelling (default: cuda; the CPU runs the "
                         "kernels' plain versions)")
    ev.add_argument("--checkpoint", default=None,
                    help="directory of model_config.json and weights.pt "
                         "(default <root>/models/checkpoints)")
    ev.add_argument("--data", default=None,
                    help="model-data dir (default <root>/processed/"
                         "model_data)")
    ev.add_argument("--predictions", default=None,
                    help="score existing predict_model NPZs from this dir "
                         "instead of running inference")
    ev.add_argument("--tile", type=int, default=288)
    ev.add_argument("--overlap", type=int, default=32)
    ev.add_argument("--batch-tiles", type=int, default=64,
                    help="tiles per forward")
    ev.add_argument("--threshold", type=float, default=0.5)
    ev.add_argument("--sweep-threshold", nargs="?", const="iou",
                    default=None, metavar="METRIC",
                    help="sweep the threshold 0.05..0.95 and report the "
                         "best by METRIC (default iou; obj_precision, "
                         "obj_recall, obj_f1 sweep at the plume level); "
                         "writes threshold_sweep.csv beside the report")
    ev.add_argument("--write-threshold", action="store_true",
                    help="write the swept best threshold to <root>/models/"
                         "threshold.json")
    ev.add_argument("--objects", action="store_true",
                    help="plume-level detection metrics: components matched "
                         "one-to-one by IoU >= --match-iou")
    ev.add_argument("--match-iou", type=float, default=0.5)
    ev.add_argument("--min-size", type=int, default=1,
                    help="component floor in pixels: smaller predicted "
                         "components are pruned, smaller true ones ignored")
    ev.add_argument("--bootstrap", type=int, nargs="?", const=1000,
                    default=0, metavar="N",
                    help="scene-level bootstrap 95%% intervals of the pooled "
                         "metrics (N resamples, default 1000)")
    ev.add_argument("--prune-level", type=int, default=None,
                    help="evaluate a deep-supervised UNet++ pruned at "
                         "fusion level L")
    ev.add_argument("--out", default=None,
                    help="report CSV (default <root>/processed/"
                         "evaluation.csv)")
    ev.set_defaults(fn=cmd_evaluate_model)

    rp = sub.add_parser("report",
                        help="campaign summary markdown + figures under "
                             "<root>/reports/")
    rp.add_argument("--root", default=os.environ.get("PLUMEKIT_ROOT",
                                                     "data"),
                    help="workspace root")
    rp.add_argument("--out", default=None,
                    help="report dir (default <root>/reports)")
    rp.set_defaults(fn=cmd_report)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
