"""Exported serving artifacts (``plumekit/infer/export.py``): the whole
sliding-window inference program captured once by ``torch.export`` and
served without the model code that traced it.

``export_sliding_infer`` traces :func:`make_sliding_infer` (one granule) or
:func:`make_multi_granule_infer` (``granules > 1``) of the checkpoint's
forward at a fixed granule geometry; the tiling, the blend and the forward's
kernels are in the program, each hand-written kernel as its
``torch.library`` op (``plumekit::fused_double_conv3x3``,
``plumekit::unet_mega``, ``plumekit::int8_conv3x3``,
``plumekit::int8_upsample2x2``). As in the JAX package, the weights are not
in the program: it takes ``(variables, images)``, so one artifact serves
every checkpoint of its architecture. Its variables are the tree of tensors
the forward reads (:func:`serving_tree`), built once per checkpoint and
device when the artifact is loaded:

* the plain forward (``route`` "module"): the module's state;
* a ``use_pallas`` checkpoint ("fused"): the folded blocks, packed for K6 on
  a card (:func:`plumekit_torch.models.fused_forward.fused_tree`);
* a ``use_mega`` checkpoint at a tile K7 takes ("mega"): K7's packed blob
  (:func:`plumekit_torch.models.kernels.unet_mega.mega_tree`); at another
  tile the program falls through to the module's forward, as the JAX
  package's does;
* ``forward="int8"`` ("int8"): the quantized variables, packed for Q1 and
  Q2 on a card (:func:`plumekit_torch.models.quantized_forward.int8_tree`),
  calibrated by the serving host.

A program holds the device of every tensor it makes, so the artifact keeps
one program per platform, each traced on its own device, and the trees of
the two differ (packed on the card, folded on the CPU)::

    program.gpu.pt2   torch.export program traced on the card
    program.cpu.pt2   the same, traced on the CPU
    meta.json         geometry, forward, route, platforms, torch version
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

_META = "meta.json"
#: the JAX package's program file: a directory holding it is that
#: package's artifact
_JAX_PROGRAM = "program.stablehlo"
#: the platforms a program is traced for, and the device each is traced on
PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}
#: highest artifact format version this reader supports: fp artifacts are
#: 1, int8 artifacts 2, since their variables are the quantized tree (the
#: JAX package's numbering)
FORMAT_VERSION = 2


def _program(platform: str) -> str:
    return f"program.{platform}.pt2"


def serving_route(unet_cfg, tile: int, forward: str = "flax") -> str:
    """The forward the program runs: "int8", or for the fp forward the
    route the module's own forward takes at a ``tile``² batch in eval mode
    (K7 where :func:`mega_eligible` allows it, else K6 under
    ``use_pallas``, else the module: cuDNN)."""
    from plumekit_torch.models.kernels.unet_mega import mega_eligible

    if forward == "int8":
        return "int8"
    if forward != "flax":
        raise ValueError(f"forward must be 'flax' or 'int8', got {forward!r}")
    routed = unet_cfg.arch == "unet" and unet_cfg.norm == "batch"
    if routed and unet_cfg.use_mega and mega_eligible(unet_cfg, tile, tile):
        return "mega"
    if routed and unet_cfg.use_pallas:
        return "fused"
    return "module"


def serving_tree(route: str, unet_cfg, variables, device):
    """``(tree, static)``: the tensors a program of ``route`` reads, made
    on ``device`` from ``variables`` (the model; for "int8" its quantized
    variables), and the ints its forward is traced with (K7's stage
    table; else empty)."""
    from plumekit_torch.models.unet import DTYPES

    device = torch.device(device)
    dtype = DTYPES[unet_cfg.compute_dtype]
    if route == "module":
        return dict(variables.state_dict()), ()
    if route == "fused":
        from plumekit_torch.models.fused_forward import fused_tree

        return fused_tree(variables, dtype, device), ()
    if route == "mega":
        from plumekit_torch.models.kernels.unet_mega import mega_tree

        return mega_tree(variables, dtype, device)
    if route == "int8":
        from plumekit_torch.models.quantized_forward import int8_tree

        return int8_tree(variables, unet_cfg, device), ()
    raise ValueError(f"unknown serving route {route!r}")


def serving_apply(route: str, unet_cfg, model, static=()):
    """``apply(tree, x) -> logits`` of ``route`` on a :func:`serving_tree`;
    ``model`` (the module, for "module") is read for its structure only:
    every tensor comes from the tree."""
    if route == "module":
        def apply(state, x):
            return torch.func.functional_call(model, state, (x,))
        return apply
    if route == "fused":
        from plumekit_torch.models.fused_forward import make_fused_tree_apply

        return make_fused_tree_apply(unet_cfg)
    if route == "mega":
        from plumekit_torch.models.kernels.unet_mega import (
            make_mega_tree_apply)

        return make_mega_tree_apply(unet_cfg, static)
    from plumekit_torch.models.quantized_forward import (
        make_quantized_tree_apply)

    return make_quantized_tree_apply(unet_cfg)


class _Program(torch.nn.Module):
    """The traced callable: no parameters of its own, so nothing of the
    checkpoint is baked into the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, variables, images):
        return self.fn(variables, images)


def _check_platforms(platforms: Sequence[str]) -> list:
    plats = [p.lower() for p in platforms]
    if not plats:
        raise ValueError("no platform to export for")
    for p in plats:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: plumekit_torch "
                             f"exports for {sorted(PLATFORMS)}")
    if "gpu" in plats and not torch.cuda.is_available():
        raise ValueError(
            "platform 'gpu' is traced on the card, but CUDA is not "
            "available here; export with --platforms cpu, or on a machine "
            "with a card")
    return plats


def export_sliding_infer(
    variables,
    unet_cfg,
    infer_cfg,
    granule_hw: Tuple[int, int],
    granules: int = 1,
    platforms: Sequence[str] = ("gpu", "cpu"),
    forward: str = "flax",
    tta: bool = False,
):
    """Trace the full inference program of the model ``variables`` for a
    fixed granule geometry, once per platform.

    ``granule_hw`` is the PADDED granule shape the program will accept
    (divisible by ``2**unet_cfg.depth``: what
    :func:`plumekit_torch.infer.sliding.pad_to_multiple` makes);
    ``granules > 1`` traces the multi-granule program, whose input is the
    (G, H, W, C) group. ``forward="int8"`` traces the int8 forward: its
    variables are the quantized tree, which the serving host makes from
    each checkpoint at load time, so the artifact stays checkpoint-agnostic
    as the fp one (a unit-range dummy batch calibrates the tree that is
    traced). ``tta`` bakes D4 test-time augmentation into the program.

    Returns ``({platform: torch.export.ExportedProgram}, meta dict)``."""
    from plumekit_torch.infer.sliding import (make_multi_granule_infer,
                                              make_sliding_infer)

    h, w = granule_hw
    div = 2 ** unet_cfg.depth
    if h % div or w % div:
        raise ValueError(
            f"granule shape {granule_hw} must be divisible by 2**depth "
            f"({div}); pad with plumekit_torch.infer.sliding.pad_to_multiple")
    route = serving_route(unet_cfg, infer_cfg.tile_size, forward)
    plats = _check_platforms(platforms)
    channels = unet_cfg.in_channels
    programs = {}
    for platform in plats:
        device = torch.device(PLATFORMS[platform])
        model = variables
        if next(model.parameters()).device.type != device.type:
            model = copy.deepcopy(variables).to(device)
        model.eval()
        tree_vars = model
        if forward == "int8":
            from plumekit_torch.models.quantized_forward import quantize_unet

            calib = np.random.default_rng(0).random(
                (1, infer_cfg.tile_size, infer_cfg.tile_size, channels),
                dtype=np.float32)
            tree_vars = quantize_unet(model, unet_cfg, calib)
        tree, static = serving_tree(route, unet_cfg, tree_vars, device)
        apply_fn = serving_apply(route, unet_cfg, model, static)
        if tta:
            from plumekit_torch.infer.tta import make_tta_apply

            apply_fn = make_tta_apply(apply_fn)
        if granules > 1:
            fn = make_multi_granule_infer(apply_fn, infer_cfg, channels)
            shape = (granules, h, w, channels)
        else:
            fn = make_sliding_infer(apply_fn, infer_cfg, channels)
            shape = (h, w, channels)
        images = torch.zeros(shape, dtype=torch.float32, device=device)
        with torch.no_grad():
            program = torch.export.export(_Program(fn), (tree, images),
                                          strict=False)
        # the example inputs are zeros and the exporting checkpoint's tree:
        # saved, they would put its weights into the artifact
        program.example_inputs = None
        programs[platform] = program

    meta = {
        "forward": forward,
        "route": route,
        "tta": bool(tta),              # informational: baked into the program
        "format_version": 2 if forward == "int8" else 1,
        "granule_hw": [int(h), int(w)],
        "granules": int(granules),
        "in_channels": int(channels),
        "depth": int(unet_cfg.depth),
        # informational: the program itself is already truncated when set
        "prune_level": (None if unet_cfg.prune_level is None
                        else int(unet_cfg.prune_level)),
        "tile_size": int(infer_cfg.tile_size),
        "overlap": int(infer_cfg.overlap),
        "batch_tiles": int(infer_cfg.batch_tiles),
        "threshold": float(infer_cfg.threshold),
        "platforms": plats,
        "torch_version": torch.__version__,
    }
    return programs, meta


def save_exported(programs: dict, meta: dict, out_dir: str) -> str:
    """Write the artifact directory; returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for platform, program in programs.items():
        path = os.path.join(out_dir, _program(platform))
        torch.export.save(program, path)
        logger.info("exported %d-byte %s program -> %s",
                    os.path.getsize(path), platform, path)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return out_dir


def load_exported(artifact_dir: str, device="cuda"):
    """Load an artifact's program for ``device``: returns ``(infer_fn,
    meta)`` where ``infer_fn(variables, image) -> (probs, masks)`` runs the
    program, ``variables`` the tree :func:`serving_tree` makes of
    ``meta["route"]``. Raises ``ValueError`` for an artifact of the JAX
    package, a newer format, or a platform it was not exported for."""
    if os.path.isfile(os.path.join(artifact_dir, _JAX_PROGRAM)) \
            and not is_artifact(artifact_dir):
        raise ValueError(
            f"{artifact_dir} is an artifact of the JAX package (jax.export "
            f"StableHLO in {_JAX_PROGRAM}); plumekit_torch serves the "
            "torch.export programs of its own export_model: re-export the "
            "checkpoint with `python -m plumekit_torch.cli export_model`")
    try:
        with open(os.path.join(artifact_dir, _META)) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{artifact_dir} is no exported artifact "
                         f"({_META}: {e}); make one with export_model")
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact {artifact_dir} has format_version "
            f"{meta['format_version']} > supported {FORMAT_VERSION}; "
            "upgrade plumekit_torch")
    backend = "gpu" if torch.device(device).type == "cuda" else "cpu"
    plats = [p.lower() for p in meta.get("platforms", [])]
    if plats and backend not in plats:
        # fail at load, with the remedy in the message
        raise ValueError(
            f"artifact {artifact_dir} was exported for platforms {plats} "
            f"but the current backend is '{backend}'; re-export with "
            f"export_model --platforms {backend} (or 'gpu,cpu' for a "
            "portable artifact)")
    # the ops the program calls are registered when their modules load
    from plumekit_torch.models.kernels import (  # noqa: F401
        fused_conv, int8_conv, int8_upsample, unet_mega)

    program = torch.export.load(
        os.path.join(artifact_dir, _program(backend))).module()

    expected_hw = tuple(meta["granule_hw"])
    granules = int(meta.get("granules", 1))
    channels = int(meta["in_channels"])
    want = ((granules,) + expected_hw + (channels,) if granules > 1
            else expected_hw + (channels,))

    def infer_fn(variables, image):
        if tuple(image.shape) != want:
            raise ValueError(
                f"exported program expects image shape {want} "
                f"(granule {expected_hw}, G={granules}; pad with "
                f"pad_to_multiple(2**{meta['depth']})), got "
                f"{tuple(image.shape)}")
        return program(variables, image)

    return infer_fn, meta


def is_artifact(path: Optional[str]) -> bool:
    """True for a directory that holds this package's artifact."""
    return bool(path) and os.path.isfile(os.path.join(path, _META)) and any(
        os.path.isfile(os.path.join(path, _program(p))) for p in PLATFORMS)
