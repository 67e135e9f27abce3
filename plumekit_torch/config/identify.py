"""The detectors' configs of ``plumekit/config/identify.py``: the same
fields and defaults, so both packages sweep the same thresholds with the
same gates (reference: ``plume_identifier_basic.py:32-37``,
``plume_identifier_rg.py:35-44``,
``plume_identifier_gaussian_profile.py:34-44``,
``plume_indetifier_blob.py:40-48``)."""

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
class BasicIdentifyConfig(BaseIdentifyConfig):
    """Fixed-threshold detector (``plume_identifier_basic.py``)."""

    win_half: int = 10
    min_frp: float = 10.0
    cluster_dist_km: float = 10.0
    aod_ratio_limit: float = 3.0
    aod_min_limit: float = 0.2
    max_plume_pixels: int = 10000
    min_plume_pixels: int = 100


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


@dataclass(frozen=True)
class GaussianIdentifyConfig(BaseIdentifyConfig):
    """Multi-scale multi-orbit detector
    (``plume_identifier_gaussian_profile.py``)."""

    threshold_steps: Tuple[float, ...] = (0.02, 0.03, 0.04)
    threshold_maxes: Tuple[float, ...] = (0.5, 0.75, 1.0)
    min_plume_pixels: int = 100
    max_plume_pixels: int = 2000
    max_lim: float = 0.1
    null_value: float = -999.0
    max_invalid_frac: float = 0.2
    min_axis_ratio: float = 8.0
    max_peaks: int = 3
    #: ``remove_small_objects(min_size=3)`` on the fire raster
    min_fire_cluster_px: int = 3
    min_fires_per_scene: int = 20
    #: square buffer dilation of the accepted mask
    dilate_plume_px: int = 5
    n_transect: int = 1000

    def threshold_sets(self) -> Tuple[Tuple[float, ...], ...]:
        return tuple(_descending_thresholds(s, m) for s, m
                     in zip(self.threshold_steps, self.threshold_maxes))


@dataclass(frozen=True)
class BlobIdentifyConfig:
    """LoG/DoG/DoH blob baseline (``plume_indetifier_blob.py:40-48``)."""

    min_sigma: float = 1.0
    max_sigma: float = 30.0
    num_sigma: int = 10
    threshold_log: float = 0.1
    threshold_dog: float = 0.1
    threshold_doh: float = 0.01
    #: pairwise disc-overlap share above which the smaller-sigma blob goes
    overlap: float = 0.5
