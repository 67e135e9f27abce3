"""The rg detector's config of ``plumekit/config/identify.py``: the same
fields and defaults, so both packages sweep the same thresholds with the
same gates (reference: ``plume_identifier_rg.py:35-44``). The other
detectors' configs come with their detectors (ROADMAP.md, item 11)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CompatFlags:
    """Opt-in reproduction of reference bugs; defaults as the JAX package.

    ``pick_larger_mask``: the reference's comment says "select the smaller
    plume mask" but its code keeps the larger one
    (``plume_identifier_rg.py:388-397``); True keeps the committed behaviour.

    ``reject_last_threshold``: the reference means to reject fires whose
    ratio argmax is the last entry but compares against an unreachable
    index (``plume_identifier_rg.py:228``); True applies the intended
    rejection.
    """

    pick_larger_mask: bool = True
    reject_last_threshold: bool = True


def _descending_thresholds(step: float, maximum: float) -> Tuple[float, ...]:
    """``np.abs(np.arange(0, maximum, step) - maximum)``, the reference's
    descending threshold sweep (``plume_identifier_rg.py:37``)."""
    return tuple(float(t) for t in np.abs(np.arange(0.0, maximum, step) - maximum))


@dataclass(frozen=True)
class BaseIdentifyConfig:
    #: half window (pixels) for fire→plume association
    win_half: int = 15
    #: per-scene fire-cluster capacity (padded with invalid entries)
    max_fires: int = 64
    #: per-scene accepted-plume capacity
    max_plumes: int = 32
    compat: CompatFlags = field(default_factory=CompatFlags)


@dataclass(frozen=True)
class RGIdentifyConfig(BaseIdentifyConfig):
    """Threshold-sweep / region-growth detector (``plume_identifier_rg.py``)."""

    min_frp: float = 10.0
    cluster_dist_km: float = 5.0
    thresholds: Tuple[float, ...] = _descending_thresholds(0.05, 1.0)
    min_plume_pixels: int = 100
    max_plume_pixels: int = 2000
    side_ratio: float = 5.0
    max_lim: float = 0.1
    #: savgol smoothing of the minor-axis transect (window, polyorder)
    savgol_window: int = 17
    savgol_polyorder: int = 3
    max_peaks: int = 1
    n_transect: int = 1000

