"""The model-input contract of ``plumekit/train/data.py`` (numpy + scipy)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from plumekit_torch.io.granule import NULL_VALUE


def fire_channel(shape, rows, cols, sigma: float = 2.0) -> np.ndarray:
    """Rasterised fire detections smoothed to a density field, max 1."""
    grid = np.zeros(shape, dtype=np.float32)
    if len(rows):
        grid[np.asarray(rows), np.asarray(cols)] = 1.0
        grid = ndimage.gaussian_filter(grid, sigma).astype(np.float32)
        m = grid.max()
        if m > 0:
            grid /= m
    return grid


def assemble_channels(aod: np.ndarray, rows, cols) -> np.ndarray:
    """(H, W, 2) float32 of [AOD with nulls zeroed, normalised fire
    density]: what the U-Net reads."""
    aod = aod.copy()
    aod[aod == NULL_VALUE] = 0.0
    fire = fire_channel(aod.shape, rows, cols)
    return np.stack([aod, fire], axis=-1).astype(np.float32)
