"""Serving-geometry tuner (``plumekit/infer/tune.py``): ``tune`` and
``--tuned``.

The serving rate depends on four knobs: tile, overlap, tiles per forward
and granules per program. Their best values are a property of the card and
of the forward, not of the model, so a deployment measures them on its own
card. :func:`tune_geometry` builds each candidate into the serving program
that ``predict_model`` and ``serve`` run (:func:`make_sliding_infer` for
one granule per program, :func:`make_multi_granule_infer` for more) and
times it: one warm-up call (the first call at a new shape packs a kernel's
weights, builds its plans and grows its scratch), then ``repeats`` calls
back to back, all under ``torch.inference_mode()`` and between two
``torch.cuda.synchronize()``, on the wall clock. The granule stack is
staged on the device before a candidate is timed and dropped after it, so
the transfer stays out of the reading.

A candidate that the card's memory or a kernel's tile rule refuses
(``torch.OutOfMemoryError``, ``ValueError``) is recorded as a failure and
ranked last. Any other error, a kernel's launch error or any other CUDA
error among them, propagates: it leaves no usable measurement, and a
broken kernel must not be ranked as a slow geometry. :func:`save_tuned`
writes the ranked table; ``predict_model --tuned`` and ``serve --tuned``
serve its winner. The artifact's keys are the JAX package's, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from plumekit_torch.config.train import InferConfig
from plumekit_torch.infer.sliding import (make_multi_granule_infer,
                                          make_sliding_infer)
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

#: default artifact name under ``<root>/models/``
TUNED_BASENAME = "tuned_geometry.json"
TUNED_VERSION = 1


@dataclass(frozen=True)
class Geometry:
    """One candidate serving geometry: the four throughput knobs."""

    tile: int           #: sliding-window tile size (px)
    overlap: int        #: blended overlap (0 = disjoint fast tiling)
    batch_tiles: int    #: tiles per forward
    granules: int       #: granules per program (G)

    def label(self) -> str:
        return (f"{self.tile}/{self.overlap} "
                f"bt={self.batch_tiles} G={self.granules}")


#: the JAX package's default grid: blended and disjoint candidates both, so
#: that the table shows the blend's cost on this card; choosing between
#: them is a quality decision (disjoint tiles flip some seam pixels), which
#: is why ``best_blended`` is reported beside ``best``
DEFAULT_CANDIDATES = "288/32,256/0,384/32,512/0,288/32/128,256/0/128"


def parse_candidates(spec: str,
                     granules: Sequence[int] = (1,)) -> List[Geometry]:
    """``tile/overlap[/batch_tiles]`` comma list × granule counts. Raises
    ValueError on a malformed field or an overlap outside [0, tile)."""
    geoms: List[Geometry] = []
    for part in spec.split(","):
        fields = part.strip().split("/")
        if len(fields) not in (2, 3):
            raise ValueError(
                f"candidate {part!r}: expected tile/overlap[/batch_tiles]")
        tile, overlap = int(fields[0]), int(fields[1])
        bt = int(fields[2]) if len(fields) == 3 else 64
        if not 0 <= overlap < tile:
            raise ValueError(
                f"candidate {part!r}: overlap must be in [0, tile) — "
                "negative overlaps leave unscored gap stripes")
        if tile < 1 or bt < 1:
            raise ValueError(f"candidate {part!r}: sizes must be >= 1")
        for g in granules:
            if g < 1:
                raise ValueError(f"granules-per-program {g} must be >= 1")
            geoms.append(Geometry(tile, overlap, bt, g))
    if not geoms:
        raise ValueError("no candidate geometries given")
    return geoms


def time_geometry(apply_fn: Callable, variables, image_stack: torch.Tensor,
                  geom: Geometry, channels: int, repeats: int = 3) -> float:
    """MPix/s of the serving program at ``geom`` over the first
    ``geom.granules`` granules of ``image_stack`` ((G_max, S, S, C), on the
    device already): granule pixels of ``repeats`` calls over their wall
    time, after one warm-up call."""
    icfg = InferConfig(tile_size=geom.tile, overlap=geom.overlap,
                       batch_tiles=geom.batch_tiles)
    if geom.granules > 1:
        infer = make_multi_granule_infer(apply_fn, icfg, channels=channels)
        image = image_stack[:geom.granules]
    else:
        infer = make_sliding_infer(apply_fn, icfg, channels=channels)
        image = image_stack[0]

    def sync():
        if image.device.type == "cuda":
            torch.cuda.synchronize(image.device)

    with torch.inference_mode():
        infer(variables, image)
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            infer(variables, image)
        sync()
        dt = time.perf_counter() - t0
    size = image_stack.shape[1] * image_stack.shape[2]
    return size * geom.granules * repeats / dt / 1e6


def tune_geometry(apply_fn: Callable, variables, channels: int,
                  granule: int, geoms: Sequence[Geometry],
                  repeats: int = 3,
                  progress: Optional[Callable[[str], None]] = None,
                  device="cuda") -> dict:
    """Time every geometry of ``geoms`` on ``device`` over random
    ``granule``² granules; returns the ranked payload. Out-of-memory and
    shape refusals are recorded (``mpix_s: null`` and the error) and ranked
    last; RuntimeError when every candidate failed."""
    device = torch.device(device)
    say = progress or (lambda msg: logger.info("%s", msg))
    g_max = max(g.granules for g in geoms)
    host_stack = np.random.default_rng(0).random(
        (g_max, granule, granule, channels), np.float32)
    results = []
    for geom in geoms:
        image_stack, oom = None, False
        try:
            # only this candidate's G granules are on the device, so that a
            # large G does not crowd the smaller candidates' memory
            image_stack = torch.from_numpy(host_stack[:geom.granules]) \
                .to(device)
            rate = time_geometry(apply_fn, variables, image_stack, geom,
                                 channels, repeats)
            results.append({**dataclasses.asdict(geom), "mpix_s": rate})
            say(f"{geom.label()}: {rate:.1f} MPix/s")
        except (torch.OutOfMemoryError, ValueError) as e:
            oom = isinstance(e, torch.OutOfMemoryError)
            results.append({**dataclasses.asdict(geom), "mpix_s": None,
                            "error": f"{type(e).__name__}: {e}"})
            say(f"{geom.label()}: FAILED ({type(e).__name__})")
        finally:
            image_stack = None
        if oom:
            torch.cuda.empty_cache()
    ranked = sorted(results,
                    key=lambda r: -(r["mpix_s"] if r["mpix_s"] else 0.0))
    if ranked[0]["mpix_s"] is None:
        raise RuntimeError(
            "every candidate geometry failed; first error: "
            + ranked[0]["error"])
    blended = [r for r in ranked if r["overlap"] > 0 and r["mpix_s"]]
    on_card = device.type == "cuda"
    return {
        "version": TUNED_VERSION,
        "granule": granule,
        "channels": channels,
        "repeats": repeats,
        "platform": "gpu" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
        "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "best": ranked[0],
        # the fastest overlap > 0 candidate, for the seam-free blend
        "best_blended": blended[0] if blended else None,
        "results": ranked,
    }


def save_tuned(path: str, payload: dict) -> None:
    """Atomic write (pid-suffixed temporary and ``os.replace``): a serve
    restart never reads a torn artifact, and two tuners never share a
    temporary."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def load_tuned(path: str) -> dict:
    """Load and validate a tuned-geometry artifact; ValueError on a version
    or a ``best`` entry this code cannot serve."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != TUNED_VERSION:
        raise ValueError(
            f"{path}: tuned-geometry version {payload.get('version')!r} "
            f"!= supported {TUNED_VERSION} — re-run `plumekit tune`")
    best = payload.get("best") or {}
    for key in ("tile", "overlap", "batch_tiles", "granules"):
        if not isinstance(best.get(key), int):
            raise ValueError(
                f"{path}: malformed 'best' entry (missing {key}) — "
                f"re-run `plumekit tune`")
    return payload
