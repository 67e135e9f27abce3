"""Inputs shared by the port's CPU parity tests and its card tests for
K1/K4, K2, K3 and K6, as numpy arrays. The CCL cases are those of
tests/test_ops_pallas_ccl.py and tests/test_ops_pallas_ccl_banded.py:
CASES holds (AOD field, descending thresholds) pairs for K1/K4, MASK_CASES
(T, H, W) bool stacks with whether they are nested for K2. No JAX here, so
that the card tests run where JAX is not installed."""

import numpy as np
from scipy import ndimage


def _field(seed, shape, smooth=1.0):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.random(shape).astype(np.float32),
                                   smooth)


def _quantile_case(seed, shape, qs, smooth=1.0):
    f = _field(seed, shape, smooth)
    return f, np.quantile(f, qs).astype(np.float32)


def _degenerate():
    """Empty, one blob, and full levels; a height that is no multiple of
    any block."""
    f = np.zeros((44, 128), np.float32)
    f[10:20, 30:60] = 1.0
    return f, np.asarray([2.0, 0.5, -1.0], np.float32)


def _width_128():
    """A width of exactly 128 (no lane padding on the TPU: wrap hazards):
    corner blocks, stripes and a full level."""
    f = np.full((40, 128), 0.2, np.float32)
    f[:, ::8] = 0.6
    f[:, 1::8] = 0.6
    f[:, 2::8] = 0.6
    for r, c in ((0, 0), (0, 125), (37, 0), (37, 125)):
        f[r:r + 3, c:c + 3] = 1.0
    return f, np.asarray([1.5, 0.8, 0.5, 0.1], np.float32)


def _serpentine(h=96, w=256, thick=3):
    """One component whose path reverses every band: 3-px corridors that
    survive the opening, joined at alternating ends; then everything."""
    f = np.zeros((h, w), np.float32)
    period = 2 * thick
    for top in range(0, h - thick + 1, period):
        f[top:top + thick, :] = 1.0
        if top + period < h:
            cols = slice(0, thick) if (top // period) % 2 == 0 \
                else slice(w - thick, w)
            f[top + thick:top + period, cols] = 1.0
    return f + 0.3, np.asarray([0.5, 0.25], np.float32)


def _thin_serpentine():
    """The 1-px serpentine of tests/test_ops_pallas_ccl_banded.py (the
    opening erases it: a level of nothing but the cross's survivors)."""
    h, w = 96, 256
    f = np.zeros((h, w), np.float32)
    f[::2, :] = 1.0
    for i in range(0, h - 2, 2):
        f[i + 1, 0 if (i // 2) % 2 == 0 else w - 1] = 1.0
    return f + 0.3, np.asarray([0.5, 0.25], np.float32)


CASES = {
    "nested_noise": lambda: _quantile_case(3, (160, 200), [0.9, 0.5, 0.2]),
    "percolation": lambda: _quantile_case(7, (96, 130), [0.7, 0.45, 0.25],
                                          0.8),
    "degenerate_levels": _degenerate,
    "width_128": _width_128,
    "serpentine": _serpentine,
    "thin_serpentine": _thin_serpentine,
    "ragged_97x131": lambda: _quantile_case(5, (97, 131), [0.8, 0.5, 0.3]),
    "ragged_61x203": lambda: _quantile_case(9, (61, 203), [0.6, 0.4], 0.7),
}


def _nested_stack(seed, shape, qs, smooth=1.0):
    f, ths = _quantile_case(seed, shape, qs, smooth)
    return np.stack([f > t for t in ths]), True


def _edge_masks():
    """Empty, the four corner pixels, corners with stripes, full; a width
    of exactly 128."""
    h, w = 40, 128
    corners = np.zeros((h, w), bool)
    corners[0, 0] = corners[0, -1] = corners[-1, 0] = corners[-1, -1] = True
    return np.stack([np.zeros((h, w), bool), corners,
                     corners | (np.arange(w) % 2 == 0),
                     np.ones((h, w), bool)]), True


def _independent_masks():
    rng = np.random.default_rng(0)
    return rng.random((3, 48, 72)) > 0.6, False


def _mask_serpentine():
    """One 1-px component whose path reverses every other row, then the
    same with every other column set."""
    h, w = 96, 256
    snake = np.zeros((h, w), bool)
    snake[::2, :] = True
    for i in range(0, h - 2, 2):
        snake[i + 1, 0 if (i // 2) % 2 == 0 else w - 1] = True
    return np.stack([snake, snake | (np.arange(w) % 2 == 0)]), True


def _fire_raster():
    """What the gaussian detector's clustering labels: a few set pixels,
    some touching, one at (0, 0), on a ragged shape; one level."""
    grid = np.zeros((1, 97, 131), bool)
    for r, c in ((0, 0), (0, 1), (1, 1), (40, 60), (41, 61), (42, 60),
                 (96, 130), (50, 5), (50, 7)):
        grid[0, r, c] = True
    return grid, False


MASK_CASES = {
    "nested_noise": lambda: _nested_stack(3, (160, 200), [0.9, 0.5, 0.2]),
    "percolation": lambda: _nested_stack(7, (96, 130), [0.7, 0.45, 0.25],
                                         0.8),
    "edge_masks": _edge_masks,
    "independent": _independent_masks,
    "serpentine": _mask_serpentine,
    "fire_raster": _fire_raster,
    "ragged_61x203": lambda: _nested_stack(9, (61, 203), [0.6, 0.4], 0.7),
}


def double_conv_case(seed, shape, cm, co):
    """Float32 inputs of one double-conv block (K6): NHWC activations, two
    HWIO weights, and a scale and a shift per conv."""
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    return [
        rng.normal(size=shape).astype(np.float32),
        (rng.normal(size=(3, 3, cin, cm)) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2, cm).astype(np.float32),
        (rng.normal(size=cm) * 0.1).astype(np.float32),
        (rng.normal(size=(3, 3, cm, co)) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2, co).astype(np.float32),
        (rng.normal(size=co) * 0.1).astype(np.float32),
    ]


def label_count_case(shape, f, seed):
    """Random labels with duplicate labs, 0 (the not-found placeholder)
    and labs that never occur."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 40, shape).astype(np.int32)
    labs = rng.integers(0, 50, (shape[0], f)).astype(np.int32)
    labs[:, 0] = 0
    if f > 2:
        labs[:, 1] = labs[:, 2]          # a duplicate
        labs[:, -1] = 10_000             # absent
    return labels, labs
