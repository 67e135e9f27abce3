"""Seeded model-ready granules: (H, W, 2) float32 stacks of AOD (nulls
zeroed) and the normalised fire density, as the program's decode hands
them to the forward. Made on the device from the seed, in a fixed number of
draws of fixed sizes for every seed, and brought to host memory.

A traffic mix's ``granule`` entry sets the scene: ``size`` (a multiple of
16), ``pool`` (distinct granules), ``plumes`` per granule, ``plume_length``
and ``plume_width`` ranges in pixels, ``plume_aod`` and ``background_aod``
ranges, ``null_share`` of pixels without retrieval, ``fires_per_plume``,
and for training samples ``mask_aod``, the plumes' own AOD above which a
pixel is labelled plume.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

#: a coarse field's pixel covers this many granule pixels a side
COARSE = 128


def _coarse_field(gen, size: int, device) -> torch.Tensor:
    """A smooth field in [0, 1): uniform noise on a coarse grid,
    bilinearly upsampled to ``size``²."""
    n = max(2, size // COARSE + 1)
    noise = torch.rand((1, 1, n, n), generator=gen, device=device)
    return F.interpolate(noise, size=(size, size), mode="bilinear",
                         align_corners=True)[0, 0]


def _uniform(gen, n: int, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def make_granule(scene: dict, gen: torch.Generator, device):
    """One (H, W, 2) granule on ``device`` and its (H, W) plume mask."""
    size = int(scene["size"])
    if size % 16:
        raise ValueError(f"granule size {size} is not a multiple of 16")
    k = int(scene["plumes"])
    lo, hi = scene["background_aod"]
    aod = lo + (hi - lo) * _coarse_field(gen, size, device)
    nulls = _coarse_field(gen, size, device)
    # plume parameters, drawn as fixed-size vectors
    y0 = _uniform(gen, k, (0, size), device)
    x0 = _uniform(gen, k, (0, size), device)
    theta = _uniform(gen, k, (0, 2 * math.pi), device)
    length = _uniform(gen, k, scene["plume_length"], device)
    width = _uniform(gen, k, scene["plume_width"], device)
    amp = _uniform(gen, k, scene["plume_aod"], device)
    nf = int(scene["fires_per_plume"])
    jitter = torch.randn((k, nf, 2), generator=gen, device=device) * 3.0
    fire = torch.zeros((size, size), device=device)
    plume = torch.zeros((size, size), device=device)
    params = torch.stack([y0, x0, theta, length, width, amp]).cpu().tolist()
    jit = jitter.cpu().numpy()
    for p, (py, px, th, ln, wd, a) in enumerate(zip(*params)):
        cy, cx = py + 0.5 * ln * math.sin(th), px + 0.5 * ln * math.cos(th)
        reach = int(ln + 3 * wd)
        ys = slice(max(0, int(cy) - reach), min(size, int(cy) + reach + 1))
        xs = slice(max(0, int(cx) - reach), min(size, int(cx) + reach + 1))
        if ys.start >= ys.stop or xs.start >= xs.stop:
            continue
        gy = torch.arange(ys.start, ys.stop, device=device,
                          dtype=torch.float32)[:, None] - cy
        gx = torch.arange(xs.start, xs.stop, device=device,
                          dtype=torch.float32)[None, :] - cx
        along = gy * math.sin(th) + gx * math.cos(th)
        across = -gy * math.cos(th) + gx * math.sin(th)
        plume[ys, xs] += a * torch.exp(-0.5 * ((along / (0.5 * ln)) ** 2
                                             + (across / wd) ** 2))
        for fy, fx in jit[p]:
            ry = int(min(size - 1, max(0, py + fy)))
            rx = int(min(size - 1, max(0, px + fx)))
            fire[ry, rx] = 1.0
    # the fire density: detections smoothed (sigma 2 px) and scaled to max 1
    r = torch.arange(-6, 7, device=device, dtype=torch.float32)
    g1 = torch.exp(-0.5 * (r / 2.0) ** 2)
    g1 = g1 / g1.sum()
    fire = F.conv2d(fire[None, None], g1.view(1, 1, -1, 1), padding=(6, 0))
    fire = F.conv2d(fire, g1.view(1, 1, 1, -1), padding=(0, 6))[0, 0]
    fire = fire / torch.clamp(fire.max(), min=1e-12)
    aod = aod + plume
    cut = torch.quantile(nulls.flatten()[::97].float(),
                         float(scene["null_share"]))
    aod = torch.where(nulls < cut, torch.zeros_like(aod), aod)
    mask = (plume > float(scene.get("mask_aod", 0.1))).float()
    return torch.stack([aod, fire], dim=-1).float(), mask


def make_pool(scene: dict, seed: int, device,
              masks: bool = False) -> List:
    """``scene["pool"]`` distinct granules from ``seed``, in host memory;
    with ``masks``, (granule, mask) pairs."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    out = []
    for _ in range(int(scene["pool"])):
        channels, mask = make_granule(scene, gen, device)
        channels = channels.cpu().numpy()
        out.append((channels, mask.cpu().numpy()) if masks else channels)
    return out


def calibration_tiles(channels: np.ndarray, tile: int, depth: int):
    """The tiles ``predict_model --int8`` calibrates on: a 3×3 grid of
    corners and midpoints over the granule, of side ``tile`` rounded down to
    the U-Net's divisibility and at most the granule's."""
    h, w = channels.shape[:2]
    div = 2 ** depth
    t = max(div, min(tile - tile % div, h, w))
    ys = sorted({int(v) for v in np.linspace(0, h - t, 3)})
    xs = sorted({int(v) for v in np.linspace(0, w - t, 3)})
    return np.stack([channels[y:y + t, x:x + t] for y in ys for x in xs])
