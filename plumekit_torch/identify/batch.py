"""Data-parallel batch identify: a stack of same-shape granules split over
a mesh axis (``plumekit/identify/batch.py``).

Scenes are independent, so there is no collective: each device runs the
threshold sweep (``identify/pipeline.make_sweep_identifier``: the K1
kernel, then K3, on the card) on its own scenes one after another, as the
JAX program maps the sweep over its local shard, and the devices run side
by side, each on a host thread of its own. Every scene's outputs equal its
single-scene sweep bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from plumekit_torch.identify.pipeline import (SweepStatics,
                                              make_sweep_identifier,
                                              validate_descending_thresholds)
from plumekit_torch.parallel.mesh import Mesh, run_per_device, shard


def batch_identify_sharded(
    aods: np.ndarray,
    statics: SweepStatics,
    thresholds,
    fire_rows: np.ndarray,
    fire_cols: np.ndarray,
    fire_valid: np.ndarray,
    mesh: Mesh,
    null_masks=None,
    axis: str = "data",
) -> Dict[str, np.ndarray]:
    """Sweep ``aods`` (B, H, W) with their fire arrays (B, F), B split over
    the mesh's ``axis``; returns the sweep's outputs stacked over the B
    scenes, as numpy. B is padded to a multiple of the axis size with empty
    scenes, which are dropped from the result. Each device's scenes go
    straight from the host to that device."""
    # the warm-started label sweep needs strictly descending thresholds
    thresholds = validate_descending_thresholds(thresholds)
    b = aods.shape[0]
    devices = mesh.axis_devices(axis)
    pad = (-b) % len(devices)
    if pad:
        def padb(x, fill=0):
            return np.concatenate(
                [x, np.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)

        aods = padb(np.asarray(aods))
        fire_rows = padb(np.asarray(fire_rows))
        fire_cols = padb(np.asarray(fire_cols))
        fire_valid = padb(np.asarray(fire_valid).astype(bool), False)
        if null_masks is not None:
            null_masks = padb(np.asarray(null_masks).astype(bool), False)
    if null_masks is None:
        null_masks = np.zeros(aods.shape, bool)
    sweep = make_sweep_identifier(statics)

    def local(device, aod, null, rows, cols, valid):
        th = torch.from_numpy(thresholds).to(device)
        outs = []
        with torch.inference_mode():
            for i in range(aod.shape[0]):
                out = sweep(aod[i], aod[i], null[i], th, rows[i], cols[i],
                            valid[i])
                outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return outs

    parts = [shard(np.ascontiguousarray(a, dtype), devices) for a, dtype in (
        (aods, np.float32), (null_masks, bool), (fire_rows, np.int32),
        (fire_cols, np.int32), (fire_valid, bool))]
    results = run_per_device(local, devices, devices, *parts)
    scenes = [out for outs in results for out in outs][:b]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


__all__ = ["batch_identify_sharded"]
